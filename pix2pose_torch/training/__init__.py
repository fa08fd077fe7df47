"""Per-object GAN training of the generator (port of
:mod:`pix2pose_tpu.training`): batch synthesis on the device
(:mod:`.data`), the GAN iteration (:mod:`.gan`) and the ``train`` CLI
(:mod:`.train`)."""
