"""On the card: one short run of the cell through the hand kernels at a
small size, correct, with the card's readings in the traced run."""
import pytest

from conftest import run_small, small_checkout


@pytest.mark.cuda
def test_the_cell_runs_correct_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    out = run_small(small_checkout(tmp_path), seed=21, traced=True,
                    device="cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert {"device_idle_pct.compact", "sig_hash_roofline.compact",
            "seg_count_roofline.compact"} <= set(out["metrics"])
