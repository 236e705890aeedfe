"""The port's hand-written CUDA kernels (forward K1/K2/K5, K1 also at V4's
head dim 88 and the V1-V3 Transformer3D's 72 and 144, backward K3/K4 and
K6/K7, and the quantized linears' Q1-Q3)
against their plain PyTorch versions, on the card. Every test here needs a CUDA device and nvcc, and
skips without one; the CPU tests (test_torch_ops.py) hold the plain versions
against the JAX package.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from easyanimate_tpu_torch.ops import attention as tattn
from easyanimate_tpu_torch.ops import flash_attention as tfa
from easyanimate_tpu_torch.ops import swa as tswa


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().cpu().numpy(), atol=tol, rtol=tol)


def _k1_route(d, sq, skv):
    """Which K1 kernel csrc/flash_fwd.cu's ea_flash_fwd_bf16 runs: "short"
    (flash_fwd_short_sm90: d 72 and 144 heads of at most 64 q and kv rows),
    "sm90" (d 64's or d 88's block, or d 72's persistent walk) or "mma"
    (the mma.sync body: d 16, 32, and 144 past 64 rows)."""
    if d in (72, 144) and sq <= 64 and skv <= 64:
        return "short"
    if d in (64, 72, 88):
        return "sm90"
    return "mma"


def _check_route(d, sq, skv, before_sm90, before_short):
    """The wrapper's counts moved by the route _k1_route names."""
    route = _k1_route(d, sq, skv)
    assert tfa.flash_attention_fwd.launches_sm90 == before_sm90 + (
        route != "mma")
    assert tfa.flash_attention_fwd.launches_short == before_short + (
        route == "short")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU tests cover the "
                    "kernels' plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,kv_valid,d", [
    (256, 256, 256, 64), (333, 1027, 1000, 64), (100, 70, 70, 32),
    (65, 129, 129, 16),
    # d 64 runs the TMA + wgmma kernel (128 q rows x 128 kv rows a tile):
    # exactly one tile; kv_valid inside the last kv tile; kv_valid on a
    # tile boundary with rows past it; one q row; the SWA cross pass cut
    (128, 128, 128, 64), (129, 257, 200, 64), (300, 1100, 1024, 64),
    (1, 300, 300, 64), (1337, 1027, 1027, 64),
    # d 88 (V4) runs the TMA + wgmma kernel too (192 q rows a block, 96 kv
    # rows a tile, each row loaded as columns 0-63 and 64-95 with TMA's
    # zeros in 88-95): the text cross pass's 333 keys; kv_valid inside the
    # last kv tile; the CLIP pass's 16 keys, fewer than one tile; one q
    # row; a self-attention block of 1,000 rows; exactly one q block and
    # one kv tile; one q row past a block; kv_valid inside the last tile
    # with rows past it; kv on a tile boundary, alone and with rows past it
    (200, 333, 333, 88), (129, 257, 200, 88), (1000, 16, 16, 88),
    (1, 100, 100, 88), (1000, 1000, 1000, 88), (192, 96, 96, 88),
    (193, 500, 500, 88), (400, 777, 700, 88), (300, 288, 288, 88),
    (300, 500, 384, 88),
    # d 72 (V1-V3) runs the TMA + wgmma kernel of d 88 with a 16-column hi
    # box (TMA's zeros in 72-79) as a persistent walk: the text pass's 120
    # keys; a frame's 1,024 tokens; kv_valid inside the last kv tile; one q
    # row past the short limit; one q row past a block. Heads of at most
    # 64 q and kv rows (V3's temporal passes over 36 frames) run the
    # short-head kernel: 36 and 64 rows; at most 64 q rows over a longer,
    # ragged kv run the walk
    (200, 120, 120, 72), (1024, 1024, 1024, 72), (400, 777, 700, 72),
    (65, 65, 65, 72), (193, 500, 500, 72), (36, 36, 36, 72),
    (64, 64, 64, 72), (36, 100, 77, 72), (1, 36, 36, 72),
    # d 144 (V1's and V2's motion modules): V2's temporal pass over 36
    # frames and V1's grid over 4 x 16 run the short-head kernel; ragged
    # and longer shapes the mma.sync body
    (36, 36, 36, 144), (64, 64, 64, 144), (100, 333, 300, 144),
    (300, 1000, 1000, 144), (1, 70, 70, 144),
    # the short-head kernel (heads of at most 64 q and kv rows, d 72 and
    # 144): kv_valid inside a head, with 48- and 64-row kv boxes; one q
    # row; q rows below a kv length past 64 (d 144: the mma.sync body;
    # d 72: the walk)
    (36, 36, 30, 144), (64, 64, 41, 144), (36, 36, 30, 72),
    (64, 64, 41, 72), (1, 64, 64, 144), (48, 48, 48, 72),
    (36, 65, 65, 144), (64, 65, 65, 72),
    # d 72's persistent walk: the text pass's 120 keys (its tiles kept in
    # the ring) at 1,024 rows; 333 keys (4 tiles: as many as the ring's
    # stages); a ragged 1,001-row head
    (1024, 120, 120, 72), (1001, 333, 333, 72), (1001, 1001, 1001, 72)])
def test_flash_kernel_matches_plain_on_card(cuda_device, sq, skv, kv_valid, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(4, n, d, generator=g, device=cuda_device
                           ).to(torch.bfloat16) for n in (sq, skv, skv))
    before = tfa.flash_attention_fwd.launches
    before_sm90 = tfa.flash_attention_fwd.launches_sm90
    before_short = tfa.flash_attention_fwd.launches_short
    o, lse = tfa.flash_attention_fwd(q, k, v, kv_valid)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    _check_route(d, sq, skv, before_sm90, before_short)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, kv_valid)
    # bf16 output and the kernel's bf16 p before p @ v
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
def test_flash_kernel_d88_ragged_heads_on_card(cuda_device):
    """K1 at d 88 on 12 heads of 1,001 rows (not a multiple of the 192-row
    q block or the 96-row kv tile), each head's k and v offset by its own
    mean: a tile read across a head's end would carry another head's
    values, and columns 88-95 read from the next row would add its first
    8 values to every score."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    bh, s, d = 12, 1001, 88
    shift = torch.arange(bh, device=cuda_device).view(bh, 1, 1) % 3 - 1.0
    q = (torch.randn(bh, s, d, generator=g, device=cuda_device)
         * d ** -0.5 * tfa.LOG2E).to(torch.bfloat16)
    k, v = ((torch.randn(bh, s, d, generator=g, device=cuda_device) + shift)
            .to(torch.bfloat16) for _ in range(2))
    before_sm90 = tfa.flash_attention_fwd.launches_sm90
    o, lse = tfa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches_sm90 == before_sm90 + 1
    o_p, lse_p = tfa.flash_attention_plain(q, k, v)
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("skv,kv_valid", [(200, 200), (300, 250), (96, 40)])
def test_flash_kernel_d88_masks_pad_columns_at_deep_scores_on_card(
        cuda_device, skv, kv_valid):
    """Every visible score of a row near -352 (q all +2, k near -2, d 88):
    the zero k rows past kv_valid that TMA fills into the last kv tile
    score 0, and would take the row max (and all of p) unless K1 hides
    columns j >= kv_valid. k carries a little noise, so o depends on which
    columns were kept."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    d = 88
    q = torch.full((4, 300, d), 2.0, device=cuda_device).to(torch.bfloat16)
    k = (-2.0 + 0.25 * torch.randn(4, skv, d, generator=g, device=cuda_device)
         ).to(torch.bfloat16)
    v = torch.randn(4, skv, d, generator=g, device=cuda_device
                    ).to(torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, k, v, kv_valid)
    torch.cuda.synchronize()
    assert lse.max().item() < -300, lse.max().item()
    assert torch.isfinite(o.float()).all()
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, kv_valid)
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(1001, 72), (36, 72), (36, 144), (65, 144)])
def test_flash_kernel_d72_d144_ragged_heads_on_card(cuda_device, s, d):
    """K1 at d 72 and 144 on 12 heads of s rows, each head's k and v offset
    by its own mean: a tile read across a head's end would carry another
    head's values, and at d 72 columns 72-79 read from the next row (the
    TMA hi box, or the mma.sync body's k8 step) would add its first 8
    values to every score."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    bh = 12
    shift = torch.arange(bh, device=cuda_device).view(bh, 1, 1) % 3 - 1.0
    q = (torch.randn(bh, s, d, generator=g, device=cuda_device)
         * d ** -0.5 * tfa.LOG2E).to(torch.bfloat16)
    k, v = ((torch.randn(bh, s, d, generator=g, device=cuda_device) + shift)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    o_p, lse_p = tfa.flash_attention_plain(q, k, v)
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,kv_valid,d", [
    (300, 200, 200, 72), (300, 300, 250, 72), (36, 36, 30, 72),
    (64, 100, 70, 144)])
def test_flash_kernel_d72_d144_mask_pad_columns_at_deep_scores_on_card(
        cuda_device, sq, skv, kv_valid, d):
    """Every visible score of a row far below 0 (q all +2, k near -2): the
    zero k rows past kv_valid (TMA's, or the mma.sync body's zero-filled
    tile rows) score 0, and would take the row max unless K1 hides columns
    j >= kv_valid."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    q = torch.full((4, sq, d), 2.0, device=cuda_device).to(torch.bfloat16)
    k = (-2.0 + 0.25 * torch.randn(4, skv, d, generator=g, device=cuda_device)
         ).to(torch.bfloat16)
    v = torch.randn(4, skv, d, generator=g, device=cuda_device
                    ).to(torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, k, v, kv_valid)
    torch.cuda.synchronize()
    assert lse.max().item() < -4 * d + 40, lse.max().item()
    assert torch.isfinite(o.float()).all()
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, kv_valid)
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,d", [
    # b*h past gridDim.y's 65,535
    (73728, 36, 36, 72), (66000, 100, 100, 72), (66000, 8, 8, 64),
    (66000, 8, 8, 88), (65537, 36, 36, 144), (73728, 36, 36, 144),
    (65537, 64, 64, 72), (73728, 64, 64, 144),
    # the short-head kernel at d 72 and 144 (36 and 64 rows): one head;
    # head counts that are not a multiple of the grid
    (1, 36, 36, 144), (1, 64, 64, 72), (133, 36, 36, 144),
    (1001, 64, 64, 144), (997, 36, 36, 72), (265, 50, 40, 72),
    # d 72's persistent walk: fewer items than SMs, and many a block; the
    # text pass's kv tiles kept across a head's q blocks, also where a
    # block's run of items spans heads; 1,024- and 1,001-row heads
    (2, 1024, 1024, 72), (300, 1024, 1024, 72), (150, 1001, 1001, 72),
    (200, 1001, 120, 72), (300, 1024, 120, 72), (150, 500, 333, 72),
    (100, 1024, 500, 72)])
def test_flash_kernel_takes_bh_past_grid_y_on_card(cuda_device, bh, sq, skv,
                                                    d):
    """K1 on many heads, each head's k and v offset by its own mean, so a
    block that read or wrote another head's rows, or kept a head's kv
    tiles in its ring past the head's end, would show: b*h past gridDim.y's
    65,535 on every K1 instance (V3's temporal pass at 768x768 is [73,728,
    36, 72]); the persistent kernels (the short-head kernel, d 72's walk)
    over heads that do not divide evenly among their blocks."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    shift = (torch.arange(bh, device=cuda_device).view(bh, 1, 1) % 5 - 2.0)
    q = (torch.randn(bh, sq, d, generator=g, device=cuda_device)
         * d ** -0.5 * tfa.LOG2E).to(torch.bfloat16)
    k, v = ((torch.randn(bh, skv, d, generator=g, device=cuda_device) + shift)
            .to(torch.bfloat16) for _ in range(2))
    before_sm90 = tfa.flash_attention_fwd.launches_sm90
    before_short = tfa.flash_attention_fwd.launches_short
    o, lse = tfa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    _check_route(d, sq, skv, before_sm90, before_short)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v)
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,window,d", [
    (4, 1000, 100, 64), (4, 777, 63, 32), (4, 300, 500, 16),
    # d 64 runs the TMA + wgmma kernel (192 q rows a block, 128-row kv
    # tiles from max(0, q0 - window)): window 0; a window past S (every
    # row sees everything); S below one q block; ragged S with a window
    # that is not a multiple of 128; a band narrower than two tiles; 12
    # heads of 1001 rows, each offset by its own mean (a tile that read
    # across a head's end would carry another head's values)
    (4, 1000, 0, 64), (4, 300, 500, 64), (4, 100, 30, 64),
    (4, 3001, 300, 64), (4, 777, 63, 64), (12, 1001, 200, 64)])
def test_swa_kernel_matches_plain_on_card(cuda_device, bh, s, window, d):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    shift = (torch.arange(bh, device=cuda_device).view(bh, 1, 1) % 3 - 1.0
             if bh == 12 else 0.0)
    q, k, v = ((torch.randn(bh, s, d, generator=g, device=cuda_device)
                + (0.0 if i == 0 else shift)).to(torch.bfloat16)
               for i in range(3))
    before = tswa.sliding_window_fwd.launches
    before_sm90 = tswa.sliding_window_fwd.launches_sm90
    o, lse = tswa.sliding_window_fwd(q, k, v, window)
    torch.cuda.synchronize()
    assert tswa.sliding_window_fwd.launches == before + 1
    assert tswa.sliding_window_fwd.launches_sm90 == before_sm90 + (d == 64)
    o_p, lse_p = tswa.sliding_window_plain(q, k, v, window)
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
def test_swa_kernel_masks_pad_rows_at_deep_scores_on_card(cuda_device):
    """Every visible score of a row near -256 (q all +2, k near -2, d 64):
    the zero k rows past S that TMA fills into the last kv tile of every
    block score 0, and would take the row max (and all of p) unless K2
    hides columns j >= S. k carries a little noise, so o depends on which
    columns were kept."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    s, window, d = 200, 50, 64
    q = torch.full((4, s, d), 2.0, device=cuda_device).to(torch.bfloat16)
    k = (-2.0 + 0.25 * torch.randn(4, s, d, generator=g, device=cuda_device)
         ).to(torch.bfloat16)
    v = torch.randn(4, s, d, generator=g, device=cuda_device
                    ).to(torch.bfloat16)
    o, lse = tswa.sliding_window_fwd(q, k, v, window)
    torch.cuda.synchronize()
    assert lse.max().item() < -200, lse.max().item()
    assert torch.isfinite(o.float()).all()
    o_p, lse_p = tswa.sliding_window_plain(q, k, v, window)
    _close(o.float(), o_p.float(), 2e-2)
    _close(lse, lse_p, 1e-3)


@pytest.mark.cuda
def test_kernels_refuse_head_dim_88_by_name_on_card(cuda_device):
    """Only K1's forward has a d 88 instance: K2-K7 refuse it, each naming
    its kernel, and so does FlashAttention's backward (K3 and K4), while
    its forward launches K1."""
    x = torch.zeros(2, 8, 88, dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros(2, 8, 1, device=cuda_device)
    with pytest.raises(ValueError, match="K2"):
        tswa.sliding_window_fwd(x, x, x, 4)
    with pytest.raises(ValueError, match="K5"):
        tswa.swa_local_global_fwd(x, x, x, x, x, 4)
    with pytest.raises(ValueError, match="K3 and K4"):
        tfa.flash_attention_bwd(x, x, x, x, lse, x)
    with pytest.raises(ValueError, match="K6 and K7"):
        tswa.sliding_window_bwd(x, x, x, x, lse, x, 4)
    q = torch.randn(1, 2, 8, 88, device=cuda_device).to(torch.bfloat16)
    q.requires_grad_(True)
    o = tattn.attention(q, q, q)
    with pytest.raises(ValueError, match="K3 and K4"):
        o.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [72, 144])
def test_kernels_refuse_head_dims_72_144_by_name_on_card(cuda_device, d):
    """Only K1's forward has d 72 and 144 instances (the JAX package trains
    no V1-V3): K2-K7 refuse them, each naming its kernel."""
    x = torch.zeros(2, 8, d, dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros(2, 8, 1, device=cuda_device)
    with pytest.raises(ValueError, match="K2"):
        tswa.sliding_window_fwd(x, x, x, 4)
    with pytest.raises(ValueError, match="K5"):
        tswa.swa_local_global_fwd(x, x, x, x, x, 4)
    with pytest.raises(ValueError, match="K3 and K4"):
        tfa.flash_attention_bwd(x, x, x, x, lse, x)
    with pytest.raises(ValueError, match="K6 and K7"):
        tswa.sliding_window_bwd(x, x, x, x, lse, x, 4)


@pytest.mark.cuda
def test_kernels_reject_unsupported_inputs_on_card(cuda_device):
    x = torch.zeros(2, 8, 48, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="d in"):
        tfa.flash_attention_fwd(x, x, x)
    y = torch.zeros(2, 8, 64, dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):
        tswa.sliding_window_fwd(y, y, y, 4)


def _grad_close(got, want, bound=2e-2):
    """max |kernel - plain| <= bound * max |plain|: the kernels round p and
    ds to bf16 before the products (as the TPU kernels do), the plain
    version stays in float32."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= bound * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,kv_valid,d", [
    (256, 256, 256, 64), (333, 1027, 1000, 64), (1001, 1100, 1037, 64),
    (100, 70, 70, 32), (65, 129, 100, 16),
    # at d 64 both are TMA + wgmma kernels. K4 (128 kv rows a block, 64 q
    # rows a stage): exactly one kv block and one q tile; kv_valid inside
    # the last kv block with rows past it; kv_valid on a block boundary
    # with a whole block past it. K3 (128 q rows a block, 128 kv rows a
    # stage): exactly one block and one tile; q rows past Sq in the second
    # block with kv_valid inside the second tile; kv_valid on a tile
    # boundary with rows past it. Both: one q row; the SWA cross pass cut
    (64, 128, 128, 64), (256, 300, 270, 64), (200, 400, 256, 64),
    (128, 128, 128, 64), (129, 257, 200, 64), (300, 1100, 1024, 64),
    (1, 300, 300, 64), (1337, 1027, 1027, 64)])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, sq, skv,
                                               kv_valid, d):
    """K3 + K4 against the plain backward, ragged and with kv_valid < S:
    dk and dv are exactly 0 past kv_valid."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(4, n, d, generator=g, device=cuda_device
                           ).to(torch.bfloat16) for n in (sq, skv, skv))
    q = (q.float() * d ** -0.5 * tfa.LOG2E).to(torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, k, v, kv_valid)
    do = torch.randn(o.shape, generator=g, device=cuda_device).to(torch.bfloat16)
    before = tfa.flash_attention_bwd.launches
    before_sm90 = tfa.flash_attention_bwd.launches_sm90
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, kv_valid)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    assert tfa.flash_attention_bwd.launches_sm90 == before_sm90 + (d == 64)
    for got, want in zip((dq, dk, dv),
                         tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       kv_valid)):
        _grad_close(got, want)
    assert not dk[:, kv_valid:].any() and not dv[:, kv_valid:].any()


@pytest.mark.cuda
def test_flash_bwd_dq_masks_pad_columns_at_deep_lse_on_card(cuda_device):
    """Every score of a row near -256 (q all +2, k near -2, d 64), so lse
    is about -248: the zero k rows past kv_valid score 0, and 2^(-lse) would
    overflow to inf there (inf * 0 = NaN in ds k) unless K3 masks the pad
    columns of its last kv tile. k carries a little noise: with a constant
    k, dq = ln2 * k * sum_j ds_j is 0 up to rounding (the ds of a row sum
    to 0), and the comparison would hold noise against noise."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    sq, skv, kv_valid, d = 200, 300, 270, 64
    q = torch.full((4, sq, d), 2.0, device=cuda_device).to(torch.bfloat16)
    k = (-2.0 + 0.25 * torch.randn(4, skv, d, generator=g, device=cuda_device)
         ).to(torch.bfloat16)
    v = torch.randn(4, skv, d, generator=g, device=cuda_device
                    ).to(torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, k, v, kv_valid)
    assert lse.max().item() < -200, lse.max().item()
    do = torch.randn(o.shape, generator=g, device=cuda_device).to(torch.bfloat16)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, kv_valid)
    torch.cuda.synchronize()
    assert torch.isfinite(dq.float()).all()
    for got, want in zip((dq, dk, dv),
                         tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       kv_valid)):
        _grad_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,window,d", [
    (4, 1000, 100, 64), (4, 3001, 300, 64), (4, 777, 63, 32),
    (4, 300, 500, 16),
    # d 64 runs K6's and K7's TMA + wgmma kernels (128 q rows a block
    # walking 64-row kv tiles from max(0, q0 - window); 128 kv rows a block
    # walking 64-row q tiles from max(0, k0 - window)): window 0; a window
    # past S (every row sees everything); S below one block; ragged S with
    # a window that is not a multiple of 64; 12 heads of 1001 rows, each
    # offset by its own mean (a tile that read across a head's end would
    # carry another head's values); S a multiple of 64 but not of 128 with
    # a window of 64 (every walk starts on a tile boundary, and the last
    # block's second consumer lies wholly past S, so its skip runs); S just
    # above one block (the last block holds one real row)
    (4, 1000, 0, 64), (4, 300, 500, 64), (4, 100, 30, 64),
    (4, 777, 63, 64), (12, 1001, 200, 64), (4, 1088, 64, 64),
    (4, 129, 40, 64)])
def test_swa_bwd_kernels_match_plain_on_card(cuda_device, bh, s, window, d):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shift = (torch.arange(bh, device=cuda_device).view(bh, 1, 1) % 3 - 1.0
             if bh == 12 else 0.0)
    q, k, v, do = ((torch.randn(bh, s, d, generator=g, device=cuda_device)
                    + shift).to(torch.bfloat16) for _ in range(4))
    q = (q.float() * d ** -0.5 * tfa.LOG2E).to(torch.bfloat16)
    o, lse = tswa.sliding_window_fwd(q, k, v, window)
    before = tswa.sliding_window_bwd.launches
    before_sm90 = tswa.sliding_window_bwd.launches_sm90
    grads = tswa.sliding_window_bwd(q, k, v, o, lse, do, window)
    torch.cuda.synchronize()
    assert tswa.sliding_window_bwd.launches == before + 1
    assert tswa.sliding_window_bwd.launches_sm90 == before_sm90 + (d == 64)
    plain = tswa.sliding_window_bwd_plain(q, k, v, o, lse, do, window)
    if window == 0:
        # a one-column softmax has no gradient with respect to its score:
        # ds = p (dp - di) = do.v - do.o is 0 up to float32 rounding in both
        # versions, so dq and dk are held to 0 (an unmasked off-diagonal
        # pair would make them O(0.1)) and dv = p^T do = do to the plain
        for got, want in zip(grads[:2], plain[:2]):
            assert got.float().abs().max().item() <= 1e-3
            assert want.float().abs().max().item() <= 1e-3
        _grad_close(grads[2], plain[2])
        return
    for got, want in zip(grads, plain):
        _grad_close(got, want)


def _out_of_band_high(g, dev, s, window, d):
    """q_i = a u(i), k_j = -a u(j) with u(i) = (cos, sin)(pi i / (2W + 2))
    and a^2 = 64: q_i . k_j = -64 cos(pi (i - j) / (2W + 2)) is below 0 for
    every pair in the band and rises to +64 outside it, where an unmasked
    edge tile would give p up to 2^64."""
    ang = torch.arange(s, device=dev, dtype=torch.float32) * (
        torch.pi / (2 * window + 2))
    u = torch.zeros(s, d, device=dev)
    u[:, 0], u[:, 1] = torch.cos(ang), torch.sin(ang)
    q = (8.0 * u).expand(4, s, d).to(torch.bfloat16).contiguous()
    return q, (-q.float()).to(torch.bfloat16).contiguous()


def _deep_lse(g, dev, s, window, d):
    """Every score near -256 (q all +2, k near -2): lse is about -249, so
    the zero kv rows past S in the last block score 0 and get p^T =
    2^(-lse) = inf unless their dk, dv rows are zeroed. k carries a little
    noise, so dq depends on which columns were kept."""
    q = torch.full((4, s, d), 2.0, device=dev).to(torch.bfloat16)
    k = (-2.0 + 0.25 * torch.randn(4, s, d, generator=g, device=dev)
         ).to(torch.bfloat16)
    return q, k


@pytest.mark.cuda
@pytest.mark.parametrize("make,s,window", [(_out_of_band_high, 1000, 100),
                                           (_deep_lse, 200, 50)],
                         ids=["out_of_band_high", "deep_lse"])
def test_swa_bwd_kernels_mask_what_they_must_on_card(cuda_device, make, s,
                                                     window):
    """K6 + K7 where a missed mask shows: out-of-band scores far above the
    band's (an edge tile of K6 or K7 left unmasked gives p up to 2^64, in
    dq as in dk and dv), and an lse so deep that the zero kv rows past S
    (S not a multiple of 128) overflow: in K6 unless the kv tile that
    crosses S masks its columns >= S, in K7 unless the epilogue zeroes
    those dk, dv rows."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    d = 64
    q, k = make(g, cuda_device, s, window, d)
    v, do = (torch.randn(4, s, d, generator=g, device=cuda_device
                         ).to(torch.bfloat16) for _ in range(2))
    o, lse = tswa.sliding_window_fwd(q, k, v, window)
    if make is _deep_lse:
        assert lse.max().item() < -200, lse.max().item()
    grads = tswa.sliding_window_bwd(q, k, v, o, lse, do, window)
    torch.cuda.synchronize()
    for got, want in zip(grads, tswa.sliding_window_bwd_plain(
            q, k, v, o, lse, do, window)):
        assert torch.isfinite(got.float()).all()
        _grad_close(got, want)


@pytest.mark.cuda
def test_attention_grads_on_card_match_cpu(cuda_device):
    """The repaired fault: backpropagating through attention and
    sliding_window_attention on the card reaches q, k and v (and so the
    to_q/to_k/to_v weights), and agrees with the CPU plain path (bf16
    weights and activations against float32: bound 5e-2 of the largest
    gradient). The head merge o.transpose(1, 2) of the blocks hands the
    backward a strided cotangent, made contiguous before the launch."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 3, 300, 64, generator=g)
    w = torch.randn(3, 64, 64, generator=g) * 0.125
    grads = {}
    for dev, dtype in (("cpu", torch.float32), (cuda_device, torch.bfloat16)):
        ww = w.to(dev, dtype).clone().requires_grad_(True)
        q, k, v = (torch.einsum("bhsd,de->bhse", x.to(dev, dtype), ww[i])
                   for i in range(3))
        o1 = tattn.attention(q, k, v, kv_valid=290)
        o2 = tswa.sliding_window_attention(q, k, v, window=40)
        merged = o1.transpose(1, 2).flatten(2)[:, :100]
        (merged.float().square().sum() + o2.float().square().sum()).backward()
        grads[str(dev)] = ww.grad.float().cpu()
    want = grads["cpu"]
    err = (grads[str(cuda_device)] - want).abs().max().item()
    assert want.abs().max() > 0 and err <= 5e-2 * want.abs().max().item(), err


@pytest.mark.cuda
def test_bwd_kernels_reject_bad_inputs_on_card(cuda_device):
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros(2, 8, 1, device=cuda_device)
    with pytest.raises(TypeError):  # float32 q
        tfa.flash_attention_bwd(x.float(), x, x, x, lse, x)
    with pytest.raises(TypeError):  # bf16 lse
        tswa.sliding_window_bwd(x, x, x, x, lse.bfloat16(), x, 4)
    strided = torch.zeros(2, 16, 64, dtype=torch.bfloat16,
                          device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd(x, x, x, x, lse, strided)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,sg,window,d", [
    (4, 1000, 1027, 100, 64), (4, 777, 300, 63, 32), (4, 300, 45, 500, 16),
    (4, 3001, 1027, 300, 64),
    # d 64 runs the TMA + wgmma kernel (192 q rows a block walking K2's
    # 128-row band tiles from max(0, q0 - window), then the global tiles):
    # window 0; a window past S; S a multiple of 64 but not of 192 with a
    # window of 64 (the last block's third consumer lies wholly past S);
    # S 129 (one q block, its third consumer holding one real row); one
    # global row; exactly one global tile; 12 heads of 1001 rows, each
    # offset by its own mean (a tile that read across a head's end, in
    # either walk, would carry another head's values)
    (4, 1000, 1027, 0, 64), (4, 300, 1027, 500, 64), (4, 1088, 1027, 64, 64),
    (4, 129, 300, 40, 64), (4, 1000, 1, 100, 64), (4, 777, 128, 63, 64),
    (12, 1001, 1027, 200, 64)])
def test_swa_fused_kernel_matches_plain_on_card(cuda_device, bh, s, sg,
                                                window, d):
    """K5 against its plain version: S not a multiple of the q block, a
    ragged global set (1,027 rows: its last tile holds 3), a window wider
    than S."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    shift = (torch.arange(bh, device=cuda_device).view(bh, 1, 1) % 3 - 1.0
             if bh == 12 else 0.0)
    q, k, v = ((torch.randn(bh, s, d, generator=g, device=cuda_device)
                + (0.0 if i == 0 else shift)).to(torch.bfloat16)
               for i in range(3))
    gk, gv = ((torch.randn(bh, sg, d, generator=g, device=cuda_device)
               + shift).to(torch.bfloat16) for _ in range(2))
    q = (q.float() * d ** -0.5 * tfa.LOG2E).to(torch.bfloat16)
    before = tswa.swa_local_global_fwd.launches
    before_sm90 = tswa.swa_local_global_fwd.launches_sm90
    o = tswa.swa_local_global_fwd(q, k, v, gk, gv, window)
    torch.cuda.synchronize()
    assert tswa.swa_local_global_fwd.launches == before + 1
    assert tswa.swa_local_global_fwd.launches_sm90 == before_sm90 + (d == 64)
    # bf16 output and the kernel's bf16 p before p @ v, in both halves
    _close(o.float(), tswa.swa_local_global_plain(q, k, v, gk, gv,
                                                  window).float(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("make,s,sg,window,g_mean", [
    (_out_of_band_high, 1000, 1027, 100, 0.0), (_deep_lse, 1000, 300, 100, -2.0)],
    ids=["out_of_band_high", "deep_global"])
def test_swa_fused_kernel_masks_what_it_must_on_card(cuda_device, make, s, sg,
                                                     window, g_mean):
    """K5 (d 64) where a missed mask shows: out-of-band scores far above the
    band's (an edge tile left unmasked gives p up to 2^64), and, with q all
    +2 and every key near -2, band and global scores near -256, so the zero
    rows past S (S not a multiple of 128) and past Sg (nor Sg), which score
    0, would win their rows' maxima unless K5 hides them. The keys carry a
    little noise around their mean, so o depends on which columns were
    kept."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    d = 64
    q, k = make(g, cuda_device, s, window, d)
    gk = (g_mean + 0.25 * torch.randn(4, sg, d, generator=g, device=cuda_device)
          ).to(torch.bfloat16)
    v, gv = (torch.randn(4, n, d, generator=g, device=cuda_device
                         ).to(torch.bfloat16) for n in (s, sg))
    if g_mean < 0:
        assert (q.float() @ gk.float().transpose(1, 2)).max().item() < -100
    before_sm90 = tswa.swa_local_global_fwd.launches_sm90
    o = tswa.swa_local_global_fwd(q, k, v, gk, gv, window)
    torch.cuda.synchronize()
    assert tswa.swa_local_global_fwd.launches_sm90 == before_sm90 + 1
    assert torch.isfinite(o.float()).all()
    _close(o.float(), tswa.swa_local_global_plain(q, k, v, gk, gv,
                                                  window).float(), 2e-2)


@pytest.mark.cuda
def test_swa_local_global_grads_match_unfused_pair_on_card(cuda_device):
    """SwaLocalGlobal's backward equals the unfused pair's on the card:
    sliding_window_attention + attention over the global set, from the same
    cotangent. dk, dv and the global gradients go through the same kernels;
    dq sums the two halves in float32 before rounding."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    b, h, s, sg, d, window = 1, 4, 1000, 300, 64, 100
    mk = lambda n: torch.randn(b, h, n, d, generator=g, device=cuda_device
                               ).to(torch.bfloat16).requires_grad_(True)
    q, k, v, gk, gv = mk(s), mk(s), mk(s), mk(sg), mk(sg)
    do = torch.randn(b, h, s, d, generator=g, device=cuda_device
                     ).to(torch.bfloat16)
    fused = tswa.swa_local_global(q, k, v, gk, gv, window)
    got = torch.autograd.grad(fused, (q, k, v, gk, gv), do)
    pair = (tswa.sliding_window_attention(q, k, v, window=window)
            + tattn.attention(q, gk, gv))
    want = torch.autograd.grad(pair, (q, k, v, gk, gv), do)
    _close(fused.float(), pair.float(), 2e-2)
    for a, w in zip(got, want):
        _grad_close(a, w)


@pytest.mark.cuda
def test_swa_fused_kernel_rejects_bad_inputs_on_card(cuda_device):
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):
        tswa.swa_local_global_fwd(x, x, x, x.float(), x, 4)
    with pytest.raises(ValueError, match="shapes"):
        tswa.swa_local_global_fwd(x, x, x, x[:1], x, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(300, 3072), (17, 12288), (1, 8), (5, 200)])
def test_quantize_rows_kernel_matches_plain_bit_for_bit(cuda_device, m, k):
    """Q1: one row of 8 (a single vector), a ragged K, an outlier row, a
    zero row (ax floored at 1e-12): the int8 values and ax exact."""
    from easyanimate_tpu_torch.ops import quant as tquant

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda_device).to(torch.bfloat16)
    x[0] *= 8.0
    if m > 2:
        x[2] = 0.0
    before = tquant.quantize_rows.launches
    xq, ax = tquant.quantize_rows(x)
    torch.cuda.synchronize()
    assert tquant.quantize_rows.launches == before + 1
    xq_p, ax_p = tquant.quantize_rows_plain(x)
    assert torch.equal(xq, xq_p) and torch.equal(ax, ax_p)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,with_bias", [(300, 3072, True),
                                           (33, 12288, False), (1, 4, True)])
def test_dequantize_rows_kernel_matches_plain(cuda_device, m, n, with_bias):
    """Q2 on int32 accumulators up to 2e8 (past 2^24, as at K = 12,288):
    the same float32 operations in the same order give the same bf16."""
    from easyanimate_tpu_torch.ops import quant as tquant

    g = torch.Generator(device=cuda_device).manual_seed(1)
    acc = torch.randint(-2 * 10 ** 8, 2 * 10 ** 8, (m, n), generator=g,
                        device=cuda_device, dtype=torch.int32)
    ax = torch.rand(m, 1, generator=g, device=cuda_device) * 8
    ws = torch.rand(n, generator=g, device=cuda_device) * 1e-3
    bias = (torch.randn(n, generator=g, device=cuda_device) if with_bias
            else None)
    before = tquant.dequantize_rows.launches
    y = tquant.dequantize_rows(acc, ax, ws, bias)
    torch.cuda.synchronize()
    assert tquant.dequantize_rows.launches == before + 1
    assert torch.equal(y, tquant.dequantize_rows_plain(acc, ax, ws, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(12288, 3072), (3072, 12288), (64, 96)])
@pytest.mark.parametrize("out", ["int8", "bf16"])
def test_unpack_int4_kernel_matches_plain_bit_for_bit(cuda_device, n, k, out):
    """Q3 in both modes, groups of 128 and (k 96) one group of 96."""
    from easyanimate_tpu_torch.ops import quant as tquant

    g = torch.Generator(device=cuda_device).manual_seed(2)
    w = torch.randn(n, k, generator=g, device=cuda_device) * 0.02
    w[:, 5] *= 10.0
    packed, scale = tquant.quantize_weight_int4(w)
    mode = "int8" if out == "int8" else torch.bfloat16
    before = tquant.unpack_int4_weight.launches
    got = tquant.unpack_int4_weight(packed, scale, mode)
    torch.cuda.synchronize()
    assert tquant.unpack_int4_weight.launches == before + 1
    want = tquant.unpack_int4_weight_plain(packed, scale, mode)
    if out == "int8":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_quant_kernels_reject_bad_inputs_on_card(cuda_device):
    from easyanimate_tpu_torch.ops import quant as tquant

    x = torch.zeros(32, 64, device=cuda_device)
    with pytest.raises(TypeError):  # float32: the kernel reads bf16
        tquant.quantize_rows(x)
    with pytest.raises(ValueError, match="multiple of 8"):
        tquant.quantize_rows(torch.zeros(32, 12, device=cuda_device,
                                         dtype=torch.bfloat16))
    acc = torch.zeros(32, 64, device=cuda_device, dtype=torch.int32)
    ax = torch.ones(32, 1, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        tquant.dequantize_rows(acc, ax, torch.ones(64, device=cuda_device),
                               out_dtype=torch.float32)
    with pytest.raises(TypeError):  # a bf16 bias
        tquant.dequantize_rows(acc, ax, torch.ones(64, device=cuda_device),
                               torch.ones(64, device=cuda_device,
                                          dtype=torch.bfloat16))
    packed = torch.zeros(8, 24, device=cuda_device, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 32"):  # 48 in-features
        tquant.unpack_int4_weight(packed, torch.ones(8, 2, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4", "w4a8"])
def test_quant_linear_on_card_matches_cpu(cuda_device, mode):
    """A bf16 QuantLinear on the card (Q1-Q3 and the library products)
    against the same module on the CPU (the plain versions): the int8
    paths give the same int32 accumulators and the same float32 epilogue,
    so the same bf16; W4A16's bf16 products sum in another order."""
    from easyanimate_tpu_torch.ops import quant as tquant

    g = torch.Generator().manual_seed(3)
    lin = tquant.QuantLinear(256, 128, mode, dtype=torch.bfloat16)
    lin.set_weight_(torch.randn(128, 256, generator=g) * 0.06)
    with torch.no_grad():
        lin.bias.normal_(0.0, 0.1, generator=g)
    x = torch.randn(3, 40, 256, generator=g).to(torch.bfloat16)
    want = lin(x)
    got = lin.to(cuda_device)(x.to(cuda_device)).cpu()
    assert got.dtype == want.dtype == torch.bfloat16
    if mode == "int4":
        _close(got.float(), want.float(), 2e-2)
    else:
        assert torch.equal(got, want)
