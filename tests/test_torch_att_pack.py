"""The attention gate's wrapper-side packing (vs_seg_tpu_torch/ops/att.py:
pack_w2, pad_channels) against a numpy reference, and the padding's
semantics: zero channels in a1 with zero taps in w2 leave the plain twin's
outputs unchanged. Inputs come from numpy with a fixed seed.
"""

import numpy as np
import pytest
import torch

from vs_seg_tpu_torch.ops import att


@pytest.mark.parametrize("kd,ca,ca16", [(3, 48, 48), (1, 5, 16), (3, 13, 16),
                                        (1, 40, 48)])
def test_pack_w2_matches_numpy(kd, ca, ca16):
    rng = np.random.default_rng(kd * 100 + ca)
    w2 = rng.standard_normal((3, 3, kd, ca, 1)).astype(np.float32)
    b2 = rng.standard_normal(1).astype(np.float32)
    want = np.zeros((kd, 3, 3, ca16), np.float32)
    for z in range(kd):
        for h in range(3):
            for w in range(3):
                want[z, h, w, :ca] = w2[h, w, z, :, 0]
    want = np.concatenate([want.reshape(-1), b2])
    got = att.pack_w2(torch.from_numpy(w2), torch.from_numpy(b2), ca16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_channels_matches_numpy():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5, 6)).astype(
        np.float32)
    got = att.pad_channels(torch.from_numpy(x), 8)
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), np.pad(x, [(0, 0)] * 4 + [(0, 2)]))


@pytest.mark.parametrize("kd", [1, 3])
def test_zero_padding_keeps_the_gate(kd):
    rng = np.random.default_rng(kd)
    a1 = torch.from_numpy(rng.random((1, 3, 5, 7, 5)).astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal((1, 3, 5, 7, 3)).astype(
        np.float32)) for _ in range(2)]
    w2 = torch.from_numpy(rng.standard_normal((3, 3, kd, 5, 1)).astype(
        np.float32))
    b2 = torch.tensor([0.1])
    ref = att.fused_attention_gate_plain(a1, xs, w2, b2)
    w2p = torch.nn.functional.pad(w2, (0, 0, 0, 3))
    got = att.fused_attention_gate_plain(att.pad_channels(a1, 8), xs, w2p, b2)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=1e-6)
    for g, r in zip(got[1], ref[1]):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


def test_attgate_ab_needs_a_card(monkeypatch, tmp_path):
    from vs_seg_tpu_torch.bench import attgate_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attgate_ab.main([str(tmp_path / "other.cu")])
