"""pix2pose_torch ``icp-robustness`` and the ICP point-to-point term
against the JAX package, on the CPU.

Both packages draw every perturbation from ``numpy.random.RandomState``
in the same order, so their sweep points start from the same pose
(initial ADD within 1e-4 mm); each refiner's final ADD must lie inside
the envelope ``tests/test_icp_robustness.py`` asserts for the JAX one.
The ``pp_weight`` term is held to the JAX ``_icp_level`` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2pose_tpu.eval.icp_refine import make_icp_refiner as jax_refiner
from pix2pose_tpu.ops import icp as jicp
from pix2pose_tpu.tools import icp_robustness as jrob
from pix2pose_torch.__main__ import main as cli
from pix2pose_torch.eval.icp_refine import make_icp_refiner
from pix2pose_torch.ops import icp as ticp
from pix2pose_torch.tools import icp_robustness as trob
from torch_icp_clouds import case_clouds

torch.set_num_threads(4)


def test_meshes_and_sweep_match_jax():
    for name in ("prism_mesh", "octa_mesh"):
        for a, b in zip(getattr(trob, name)(), getattr(jrob, name)()):
            np.testing.assert_array_equal(a, b)
    assert trob.SWEEP == jrob.SWEEP
    assert (trob.IM_H, trob.IM_W) == (jrob.IM_H, jrob.IM_W)
    np.testing.assert_array_equal(trob.K, jrob.K)


@pytest.mark.parametrize("case,bar", [
    ((10.0, 20.0, 0.0, 0.0, 1.0), 1.0),     # clean, inside the basin
    ((10.0, 20.0, 2.0, 0.1, 0.6), 5.0),     # noise + outliers + overlap
])
def test_sweep_case_matches_jax_envelope(case, bar):
    verts, faces = trob.prism_mesh()
    got = trob.run_case(verts, faces, *case, seed=0, device="cpu",
                        refiner=make_icp_refiner(verts / 1000.0, faces,
                                                 trob.IM_H, trob.IM_W,
                                                 device="cpu"))
    ref = jrob.run_case(verts, faces, *case, seed=0,
                        refiner=jax_refiner(verts / 1000.0, faces,
                                            jrob.IM_H, jrob.IM_W))
    assert abs(got["add_init"] - ref["add_init"]) < 1e-4
    assert got["ok"] and ref["ok"]
    assert got["add_final"] < bar and ref["add_final"] < bar, (got, ref)


def test_pp_weight_matches_jax_icp_level():
    """One level of 15 Gauss-Newton steps with ``pp_weight=0.1`` on the
    5 deg / 10 mm sweep point's clouds (the refiner's samples after its
    centroid pre-alignment, 256 source and 1024 target points): R and t
    within 1e-5 of the JAX ``_icp_level`` run un-jitted with a Python
    float, and of the port's own float64 run. On the 10 deg / 20 mm
    point the two packages end ~5e-4 m apart with the term on, as far as
    the port's float32 run lies from its float64 run: nearest neighbours
    and the median rejection flip on float32 rounding there, so that
    point holds no 1e-5 bar in either package.

    The JAX jitted API cannot take the term: ``pp_weight`` is not one of
    ``icp_point_to_plane``'s static arguments, so ``if pp_weight > 0``
    meets a tracer and raises."""
    src, sv, tgt, tn, tv = case_clouds(trob.SWEEP[0], 0, 256, 1024,
                                       device="cpu")
    with jax.default_matmul_precision("highest"):
        R_j, t_j, _ = jicp._icp_level(
            jnp.eye(3), jnp.zeros(3), *(jnp.asarray(x.numpy()) for x in
                                        (src, tgt, tn, sv, tv)),
            15, 2.5, 0.005, 0.1)

    def port(dtype, pp_weight):
        return ticp._icp_level(
            torch.eye(3, dtype=dtype)[None], torch.zeros(1, 3, dtype=dtype),
            *(x[None].to(dtype) for x in (src, tgt, tn)), sv[None],
            tv[None], 15, 2.5, 0.005, pp_weight=pp_weight)

    R_t, t_t, _ = port(torch.float32, 0.1)
    np.testing.assert_allclose(R_t[0].numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t[0].numpy(), np.asarray(t_j), atol=1e-5)
    R_d, t_d, _ = port(torch.float64, 0.1)
    np.testing.assert_allclose(t_t[0].numpy(), t_d[0].numpy(), atol=1e-5)
    # the term moves the solution (it is not a no-op)
    _, t_0, _ = port(torch.float32, 0.0)
    assert float((t_0 - t_t).abs().max()) > 1e-6
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jicp.icp_point_to_plane(src.numpy(), tgt.numpy(), tn.numpy(),
                                sv.numpy(), tv.numpy(), pp_weight=0.1)


def test_cli_prints_the_sweep_table(capsys):
    """``python -m pix2pose_torch icp-robustness`` at one seed: a table
    row per sweep point, every ADD finite, and the 45 deg / 80 mm point
    below 50x its initial ADD (the trust region's guarantee,
    ``tests/test_icp_robustness.py``)."""
    rows = cli(["icp-robustness", "--seeds", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("| rot(deg) |") and len(out) == 2 + len(rows)
    assert [r["case"] for r in rows] == trob.SWEEP
    assert all(np.isfinite([r["add_init_med"], r["add_final_max"]]).all()
               for r in rows)
    assert rows[-1]["add_final_max"] < 50.0 * rows[-1]["add_init_med"]
