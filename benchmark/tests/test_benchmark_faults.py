"""A whole run with the timed path broken underneath comes out not
correct: each fault a cell can have (serving: an answer altered where it
is produced, poses dropped; training: half of the batch left out, a step
that returns its state unchanged), and for a serving fault by the number
that is there for it. On the CPU at a tiny size; the harness's look for a
card is skipped."""

from __future__ import annotations

import pytest

from benchmark import common, control


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny.rgb", "altered_answer", "inlier_mismatch"),
    ("tiny.rgb", "dropped_poses", "valid_mismatch"),
    ("tiny.train", "half_batch", None),
    ("tiny.train", "unchanged", None),
])
def test_fault_makes_the_run_not_correct(tiny_root, cell, fault, number):
    rows = control.run_modes(cell, [3000000031], fault, 3.0, "cpu",
                             root=tiny_root)
    assert rows[0]["correct"] is False, rows[0]["readings"]
    if number is not None:
        limit = common.load_cell(cell, tiny_root)[0]["limits"][number]
        assert rows[0]["readings"][number] > limit, rows[0]["readings"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny.rgb", "tiny.train"])
def test_tf32_control_is_not_correct(tiny_root, card, cell):
    rows = control.run_modes(cell, [3000000041, 3000000042, 3000000043],
                             "tf32", 3.0, card, root=tiny_root)
    assert not any(r["correct"] for r in rows), rows
