"""The dry run of the training cells whose mesh path once failed in the
port, each in a subprocess at full width on fake tensors over
the fake 256-rank mesh, one microbatch at remat "none", each ``ok``
(``test_torch_dryrun_paths.py`` has the serving cells):

* the MoE FFN's backward over split experts (granite-moe-1b-a400m
  ``train_4k``);
* attention heads that the 16-way "model" axis does not divide, in
  backward (recurrentgemma-2b ``train_4k``: 10 heads, 1 kv head);
* the encoder-decoder's count (seamless-m4t-large-v2 ``train_4k``):
  traced FLOPs within the reference's band of the analytic count once the
  whole-vocabulary head is accounted for, and no rank holding anything of
  the global batch's logits' size.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config
from test_torch_dryrun_paths import BAND, _dryrun, _record

FLAGS = ("--accum", "1", "--remat", "none")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-2b"])
def test_repaired_train_cell_traces(tmp_path, arch):
    _dryrun(tmp_path, arch, "train_4k", "single", *FLAGS)
    rec = _record(tmp_path, arch, "train_4k", "single", "tp_fsdp")
    assert rec["status"] == "ok", rec.get("error")
    counts = rec["collectives_hlo"]["count_by_op"]
    assert counts.get("all-gather", 0) >= 1 and counts.get("reduce-scatter", 0) >= 1


def test_encdec_train_cell_counts(tmp_path):
    """seamless-m4t-large-v2 ``train_4k`` on 16 x 16, remat "none", one
    microbatch.  Its vocabulary (256206) divides no axis, so the logits
    stay whole over "model" (``spec_for``'s guard, as in the reference)
    and every "model" rank does the head's three products over all of it
    for its "data" rows: 6 x (256 x 4096 / 16) x 1024 x 256206 FLOPs, where
    the analytic count takes 1/16 of that.  Less that excess, traced over
    analytic is in the band.  The gold logit is a one-hot product on the
    local logits, so nothing of the size of the global batch's float32
    logits (256 x 4096 x 256206 x 4 bytes) is held on a rank."""
    _dryrun(tmp_path, "seamless-m4t-large-v2", "train_4k", "single", *FLAGS)
    rec = _record(tmp_path, "seamless-m4t-large-v2", "train_4k", "single", "tp_fsdp")
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("seamless-m4t-large-v2")
    B, T, data, model = 256, 4096, 16, 16
    excess = 6 * (B * T / data) * cfg.d_model * cfg.vocab_size * (1 - 1 / model)
    r = (rec["cost_hlo_raw"]["flops"] - excess) / rec["roofline"]["flops_per_device"]
    assert BAND[0] < r < BAND[1], r
    mem = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    assert mem < B * T * cfg.vocab_size * 4, mem / 2 ** 30
