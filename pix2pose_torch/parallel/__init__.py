"""Multi-process parallelism on ``torch.distributed``: data-parallel GAN
steps, object-parallel multi-model training and sharded inference."""

from pix2pose_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    host_local_to_global,
    init_distributed,
    make_mesh,
    make_parallel_train_step,
    process_slice,
    replicate,
    shard_batch,
    shard_inference_inputs,
)
