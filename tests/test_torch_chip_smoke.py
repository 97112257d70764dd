"""chip_smoke.py's result line: one clock per key in every row. ``ms``,
``plain_ms`` and ``library_ms`` are back-to-back medians whether a kernel
was timed once (the MLP kernels) or both back to back and from a CUDA
graph (the attention kernels); the graphed medians go beside them as
``graphed_*``."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("graphed", [False, True])
def test_result_line_keys_use_one_clock(graphed):
    cs = _chip_smoke()
    res = cs.Results()
    eager = {"ms": [0.05, 0.06, 0.07, 0.08, 0.09],
             "plain_ms": [0.3, 0.31, 0.32, 0.33, 0.34],
             "library_ms": [0.04, 0.05, 0.055, 0.06, 0.07]}
    dev = {k: [t / 4 for t in ts] for k, ts in eager.items()}
    times = {k: (dev[k], eager[k]) if graphed else eager[k] for k in eager}
    res.timing("flash_attention", times["ms"], times["plain_ms"],
               flops=1e9, nbytes=1e7, kind="bf16",
               library_ms=times["library_ms"])
    row = res.rows["flash_attention"]
    for key, ts in eager.items():
        assert row[key] == ts[2]
        if graphed:
            assert row["graphed_" + key] == dev[key][2]
        else:
            assert "graphed_" + key not in row
    assert row["bound_by"] == "bytes"
    from repro_torch.launch.hloprof import PEAK_BYTES
    assert row["bound_ms"] == pytest.approx(1e7 / PEAK_BYTES * 1e3)
