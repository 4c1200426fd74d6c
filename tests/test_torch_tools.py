"""The port's measurement tools (resshift_tpu_torch/tools) run end to end on
the CPU at tiny sizes through the plain versions: each prints its JSON
line with the device, its results (times null: none is measured on the
CPU) and its kernels' launch counts (zero).  Without a card, the default
--device cuda raises; profile_winograd_tilings, which builds kernels, and
profile_kernels, which only times them, have no CPU mode."""

import json

import pytest
import torch

from resshift_tpu_torch.tools import (profile_attn_variants, profile_conv, profile_kernels,
                                      profile_unet, profile_winograd, profile_winograd_tilings)

torch.set_num_threads(1)
FAST = ["--device", "cpu", "--n-iter", "1", "--reps", "1"]
RUNS = [
    (profile_unet, ["--batch", "1", "--phases", "attn_kernel,attn_plain,swin8,res8,gn32"]),
    (profile_winograd, ["--batch", "1", "--only=res@16", "--plain-formulation"]),
    (profile_conv, ["--batch", "1", "--rows", "1,4"]),
    (profile_attn_variants, ["--batch", "1"]),
]


@pytest.mark.parametrize("tool,args", RUNS, ids=[m.__name__.rsplit(".", 1)[1] for m, _ in RUNS])
def test_tool_runs_on_the_cpu(capsys, tool, args):
    out = tool.main(args + FAST)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert printed["device"] == {"type": "cpu", "card": "cpu"}
    assert printed["results"]
    assert all(v["launches"] == 0 for v in printed["launches"].values())


def test_profile_results(capsys):
    unet = profile_unet.main(["--batch", "1", "--phases", "attn_kernel"] + FAST)["results"]
    # (64, 64, 192) windows, 6 heads: qkv, scores, p v and proj
    assert unet["attn_kernel"]["gflops"] == pytest.approx(90.2e9 / 64 / 1e9, rel=1e-3)
    assert unet["attn_kernel"]["ms"] is None and unet["attn_kernel"]["mfu"] is None
    wino = profile_winograd.main(["--batch", "1", "--only=res@64"] + FAST)["results"]
    assert wino["unet res@64  160ch"]["rel_err"] < 2 ** -7  # bf16 output rounding
    conv = profile_conv.main(["--batch", "1", "--rows", "8"] + FAST)["results"]
    assert conv["max_abs_err"] <= 2 * conv["bf16_scale"]
    attn = profile_attn_variants.main(["--batch", "1"] + FAST)["results"]
    assert attn["f32_vs_production_max_abs_diff"] < 0.05


@pytest.mark.parametrize("tool", [profile_unet, profile_winograd, profile_conv,
                                  profile_attn_variants, profile_winograd_tilings])
def test_tool_without_a_card_raises(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--batch", "1"])


def test_tilings_probe_has_no_cpu_mode():
    """profile_winograd_tilings builds kernels: on the CPU it raises before
    it writes or compiles anything."""
    with pytest.raises(RuntimeError, match="needs the card"):
        profile_winograd_tilings.main(["--device", "cpu"])


def test_profile_unet_f32(capsys):
    """--dtype f32 runs the attention phases in float32 (on the card: K9's
    FMA kernel), the same FLOPs counted."""
    out = profile_unet.main(["--batch", "1", "--phases", "attn_kernel,attn_plain", "--dtype",
                             "f32"] + FAST)
    assert out["results"]["attn_kernel"]["gflops"] == pytest.approx(90.2e9 / 64 / 1e9, rel=1e-3)
    assert set(out["launches"]) >= {"window_attn_tc", "window_attn"}
    with pytest.raises(SystemExit):
        profile_unet.main(["--dtype", "f16"] + FAST)


def test_profile_kernels_needs_the_card(monkeypatch):
    """profile_kernels has no CPU mode, and without a card its default
    --device cuda raises."""
    with pytest.raises(RuntimeError, match="needs the card"):
        profile_kernels.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_kernels.main([])
