"""The controls, at a size a test run holds: the reference with the nets'
operands in float8 e4m3, and with the geometry's results in bfloat16, put
in the program's place fails the check the program passes, in every cell
(TF32 does nothing on the CPU; the chip's readings of all three at the
cells' own sizes are in PERF.md)."""

from __future__ import annotations

import pytest

from benchmark import calibrate


@pytest.mark.parametrize("cell", ["register.scan13k", "track.scan13k", "track_batch.scan13k_x8"])
def test_the_controls_fail_what_the_program_passes(tiny, cell):
    controls = ("fp8_nets", "bf16_geometry")
    summary = calibrate.readings(cell, [2**31 + 1, 2**31 + 2], [2**31 + 3], 0.3, "cpu",
                                 root=tiny, out=lambda line: None, controls=controls)
    assert all(r["lower"] <= r["limit"] for r in summary.values()), summary
    for control in controls:
        failed = [k for k, r in summary.items() if r["upper"][control] > r["limit"]]
        assert any(summary[k]["upper"][control] >= 3 * summary[k]["lower"] for k in failed), \
            (control, summary)
