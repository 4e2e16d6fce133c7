"""The port's hand-written kernels on the card (marker `cuda`).

Without a CUDA card every test here skips. On a card they build the
kernels and hold each against its plain PyTorch version, and the whole
`DepthNet` against its plain path. This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Reference: the plain version run in float64 on the card (cuDNN may pick
FFT or Winograd algorithms, whose float32 error is larger than a direct
sum's). Tolerance: 1e-5 times the larger of 1 and the reference's largest
magnitude, for the float32 kernels' sums taken in another order. Weights
are fan-in scaled, as a trained net's are, so the sigmoid sees O(1) inputs.
"""
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda
ATOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


def _close(got, want) -> bool:
    return (got - want).abs().max().item() <= ATOL * max(1.0, want.abs().max().item())


def _f64(*ts):
    return [t.double() for t in ts]


def _rand(rs, *shape, scale=1.0):
    return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()


@pytest.mark.parametrize('b,h,w,c,k', [(2, 16, 24, 96, 7), (1, 9, 13, 45, 3),
                                       (2, 24, 40, 160, 5), (1, 17, 33, 70, 9),
                                       # bands of several rows (the row ring), float4 and scalar
                                       (4, 96, 160, 128, 7), (2, 96, 160, 70, 7),
                                       (8, 97, 161, 96, 5)])
def test_dwconv_kernel_matches_plain(card, b, h, w, c, k):
    from slowtv_monodepth_tpu_torch.ops import dwconv
    rs = np.random.RandomState(0)
    x, wt, bias = _rand(rs, b, h, w, c), _rand(rs, c, 1, k, k, scale=1 / k), _rand(rs, c)
    n = dwconv.depthwise_conv.launches
    out = dwconv.depthwise_conv(x, wt, bias)
    torch.cuda.synchronize()
    assert dwconv.depthwise_conv.launches == n + 1
    ref = dwconv.depthwise_conv_plain(*_f64(x, wt, bias))
    assert _close(out, ref)


@pytest.mark.parametrize('b,h,w,ci,cd', [(2, 32, 24, 6, 5), (1, 48, 40, 8, 4),
                                         (2, 16, 24, 64, 32), (1, 8, 12, 32, 16)])
def test_decoder_stage_kernel_matches_plain(card, b, h, w, ci, cd):
    from slowtv_monodepth_tpu_torch.ops import decoder_stage
    rs = np.random.RandomState(1)
    args = (_rand(rs, b, h, w, ci, scale=0.5),
            _rand(rs, cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)), _rand(rs, cd, scale=0.1),
            _rand(rs, cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, cd, scale=0.1),
            _rand(rs, 1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, 1, scale=0.1))
    n = decoder_stage.fused_upconv_stage.launches
    feat, disp = decoder_stage.fused_upconv_stage(*args)
    torch.cuda.synchronize()
    assert decoder_stage.fused_upconv_stage.launches == n + 1
    f_ref, d_ref = decoder_stage.fused_upconv_stage_plain(*_f64(*args))
    assert _close(feat, f_ref)
    assert _close(disp, d_ref)


@pytest.mark.parametrize('kernel', ['dwconv', 'decoder_stage'])
def test_kernels_take_views_that_start_off_alignment(card, kernel):
    """A contiguous view one float into its storage (not 16-byte aligned)."""
    from slowtv_monodepth_tpu_torch.ops import decoder_stage, dwconv
    rs = np.random.RandomState(3)
    shape = (1, 10, 12, 32)
    x = torch.empty(int(np.prod(shape)) + 1, device='cuda')[1:].view(shape)
    x.copy_(_rand(rs, *shape, scale=0.5))
    if kernel == 'dwconv':
        args = (x, _rand(rs, 32, 1, 7, 7, scale=1 / 7), _rand(rs, 32))
        got, want = [dwconv.depthwise_conv(*args)], [dwconv.depthwise_conv_plain(*_f64(*args))]
    else:
        args = (x, _rand(rs, 16, 32, 3, 3, scale=1 / np.sqrt(288)), _rand(rs, 16, scale=0.1),
                _rand(rs, 16, 16, 3, 3, scale=1 / 12), _rand(rs, 16, scale=0.1),
                _rand(rs, 1, 16, 3, 3, scale=1 / 12), _rand(rs, 1, scale=0.1))
        got = decoder_stage.fused_upconv_stage(*args)
        want = decoder_stage.fused_upconv_stage_plain(*_f64(*args))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _close(g, w)


def test_depthnet_kernel_path_matches_plain_path_in_float64(card):
    from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
    from slowtv_monodepth_tpu_torch.ops import decoder_stage
    cfg = dict(enc_name='convnext_atto', out_scales=(0, 1, 2, 3))
    nets = [DepthNet(**cfg, kernels=k) for k in (True, False)]
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(nets[0], 0).items()}
    for net in nets:
        net.load_state_dict(sd)
    kernel_net, plain_net = nets[0].cuda().eval(), nets[1].double().cuda().eval()
    x = _rand(np.random.RandomState(2), 2, 3, 64, 96)
    n = decoder_stage.fused_upconv_stage.launches
    with torch.no_grad():
        got, want = kernel_net(x)['disp'], plain_net(x.double())['disp']
    assert decoder_stage.fused_upconv_stage.launches == n + 2
    for s in range(4):
        assert _close(got[s], want[s])


# ------------------------------------------------------------ training kernels
def _as_nhwc_taps(rs, c, k):
    return _rand(rs, c, 1, k, k, scale=1 / k)


@pytest.mark.parametrize('b,h,w,c,k', [(2, 16, 24, 96, 7), (1, 9, 13, 45, 3),
                                       (2, 11, 19, 70, 7), (1, 12, 20, 33, 9)])
def test_dwconv_gradient_on_the_card_matches_plain(card, b, h, w, c, k):
    """x, taps and bias all get the plain version's gradient (float64)."""
    from slowtv_monodepth_tpu_torch.ops import dwconv
    rs = np.random.RandomState(4)
    x, wt, bias, g = (_rand(rs, b, h, w, c), _as_nhwc_taps(rs, c, k), _rand(rs, c),
                      _rand(rs, b, h, w, c))
    leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
    n_fwd = dwconv.depthwise_conv.launches
    out = dwconv.depthwise_conv(*leaves)
    assert out.grad_fn is not None, 'the kernel output is cut off from autograd'
    n_dw = dwconv.dwconv_dw.launches
    out.backward(g)
    torch.cuda.synchronize()
    ref = [t.double().requires_grad_() for t in (x, wt, bias)]
    dwconv.depthwise_conv_plain(*ref).backward(g.double())
    for got, want in zip(leaves, ref):
        assert got.grad is not None
        assert (got.grad - want.grad).abs().max().item() <= \
            ATOL * np.sqrt(b * h * w) * max(1.0, want.grad.abs().max().item())
    assert dwconv.depthwise_conv.launches == n_fwd + 2  # forward + dx
    assert dwconv.dwconv_dw.launches == n_dw + 1


def _stage_args(rs, b, h, w, ci, cd):
    return [_rand(rs, b, h, w, ci, scale=0.5),
            _rand(rs, cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)), _rand(rs, cd, scale=0.1),
            _rand(rs, cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, cd, scale=0.1),
            _rand(rs, 1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), _rand(rs, 1, scale=0.1)]


@pytest.mark.parametrize('b,h,w,c,k,offset', [(4, 24, 40, 512, 7, 0), (8, 12, 20, 768, 7, 0),
                                              (4, 96, 160, 128, 7, 0), (2, 37, 53, 70, 7, 0),
                                              (2, 25, 41, 64, 5, 1), (1, 9, 13, 45, 9, 0)])
def test_tap_gradient_kernel_matches_plain_and_repeats(card, b, h, w, c, k, offset):
    """Kernel 2 on its own plan (tiles, blocks, clusters, partials) against
    float64, two calls bitwise equal; `offset` 1: views of x and g one float
    into their storage (the 4-byte copies)."""
    from slowtv_monodepth_tpu_torch.ops import dwconv
    rs = np.random.RandomState(6)
    x, g = _rand(rs, b, h, w, c), _rand(rs, b, h, w, c, scale=1 / np.sqrt(b * h * w))
    if offset:
        x, g = [torch.empty(t.numel() + 1, device='cuda')[1:].view(t.shape).copy_(t) for t in (x, g)]
    n = dwconv.dwconv_dw.launches
    got = dwconv.dwconv_dw(x, g, k)
    again = dwconv.dwconv_dw(x, g, k)
    torch.cuda.synchronize()
    assert dwconv.dwconv_dw.launches == n + 2
    assert torch.equal(got, again)
    assert (got.double() - dwconv.dwconv_dw_plain(x.double(), g.double(), k)).abs().max().item() <= ATOL


STAGE_BWD_CASES = [(2, 16, 24, 64, 32), (1, 8, 12, 32, 16), (2, 23, 37, 6, 5), (1, 21, 19, 20, 20),
                   (1, 2, 3, 4, 3), (2, 3, 2, 2, 2), (1, 2, 2, 40, 33)]


@pytest.mark.parametrize('cotangents', ['both', 'feat', 'disp'])
@pytest.mark.parametrize('b,h,w,ci,cd', STAGE_BWD_CASES)
def test_decoder_stage_backward_kernel_matches_plain(card, b, h, w, ci, cd, cotangents):
    """Kernel 4 through the autograd Function against autograd through the
    plain stage in float64; each gradient to 1e-5 of its own largest magnitude
    (an exactly zero gradient must come out exactly zero), the weight and bias
    sums times sqrt(pixels) / 16 for their length (>= 1)."""
    from slowtv_monodepth_tpu_torch.ops import decoder_stage
    rs = np.random.RandomState(5)
    args = _stage_args(rs, b, h, w, ci, cd)
    g_feat = _rand(rs, b, 2 * h, 2 * w, cd) if cotangents != 'disp' else None
    g_disp = _rand(rs, b, 2 * h, 2 * w, 1) if cotangents != 'feat' else None
    leaves = [t.clone().requires_grad_() for t in args]
    n = decoder_stage.fused_upconv_stage_bwd.launches
    feat, disp = decoder_stage.fused_upconv_stage(*leaves)
    assert feat.grad_fn is not None and disp.grad_fn is not None, 'cut off from autograd'
    pairs = [(o, g) for o, g in ((feat, g_feat), (disp, g_disp)) if g is not None]
    got = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])
    torch.cuda.synchronize()
    assert decoder_stage.fused_upconv_stage_bwd.launches == n + 1
    want = decoder_stage.fused_upconv_stage_bwd_plain(
        *_f64(*args), *(None if g is None else g.double() for g in (g_feat, g_disp)))
    wsum = max(1.0, np.sqrt(4 * b * h * w) / 16)
    for name, g, w_ in zip(('dx', 'dwa', 'dba', 'dwb', 'dbb', 'dwo', 'dbo'), got, want):
        assert g.shape == w_.shape
        tol = ATOL * w_.abs().max().item() * (1.0 if name == 'dx' else wsum)
        err = (g - w_).abs().max().item()
        assert err <= tol, f'{name}: {err:.3g} > {tol:.3g}'


def test_decoder_stage_backward_honours_needs_input_grad(card):
    """Only the weights of conv_b require grad: the others come back None."""
    from slowtv_monodepth_tpu_torch.ops import decoder_stage
    rs = np.random.RandomState(8)
    args = _stage_args(rs, 1, 6, 5, 8, 4)
    args[3].requires_grad_()
    feat, disp = decoder_stage.fused_upconv_stage(*args)
    (feat.sum() + disp.sum()).backward()
    torch.cuda.synchronize()
    want = decoder_stage.fused_upconv_stage_bwd_plain(
        *_f64(*args), torch.ones_like(feat).double(), torch.ones_like(disp).double())
    assert _close(args[3].grad, want[3])
    assert all(t.grad is None for i, t in enumerate(args) if i != 3)
    with torch.no_grad():
        decoder_stage.fused_upconv_stage(*args)  # serving still runs


def test_depthnet_gradients_with_fused_stages_match_plain_path(card):
    """Every parameter's gradient, kernel path (float32) vs plain path (float64)."""
    from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
    from slowtv_monodepth_tpu_torch.ops import decoder_stage
    cfg = dict(enc_name='convnext_atto', out_scales=(0, 1, 2, 3))
    nets = [DepthNet(**cfg, kernels=k) for k in (True, False)]
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(nets[0], 0).items()}
    for net in nets:
        net.load_state_dict(sd)
    kernel_net, plain_net = nets[0].cuda().train(), nets[1].double().cuda().train()
    x = _rand(np.random.RandomState(2), 2, 3, 64, 96)
    n = decoder_stage.fused_upconv_stage_bwd.launches
    for net, inp in ((kernel_net, x), (plain_net, x.double())):
        sum((d * d).mean() for d in net(inp)['disp'].values()).backward()
    assert decoder_stage.fused_upconv_stage_bwd.launches == n + 2
    for (k, p), q in zip(kernel_net.named_parameters(), plain_net.parameters()):
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
        assert (p.grad - q.grad).abs().max().item() <= 1e-4 * max(
            1e-6, q.grad.abs().max().item()), k


WARP_BF16_CASES = [(2, 24, 160, 3, 16, 200), (1, 16, 128, 1, 16, 128), (3, 37, 53, 2, 37, 53),
                   (1, 5, 7, 8, 9, 4), (2, 9, 11, 4, 6, 7), (1, 8, 8, 5, 8, 8),
                   # C = 4 on the kernel's runs of 512 pixels: one run, two, two and a part
                   (1, 16, 32, 4, 16, 32), (2, 20, 30, 4, 16, 64), (2, 20, 30, 3, 23, 45)]


@pytest.mark.parametrize('b,h,w,c,ho,wo', WARP_BF16_CASES)
def test_packed_warp_kernel_matches_plain_and_float32_kernel(card, b, h, w, c, ho, wo):
    """Kernel 6 on a bfloat16 source against the plain version on the widened
    source (float64) and against kernel 5 on the widened source."""
    from slowtv_monodepth_tpu_torch.ops import sample
    rs = np.random.RandomState(6)
    img = _rand(rs, b, h, w, c).to(torch.bfloat16)
    fx = torch.from_numpy(np.clip(rs.uniform(-0.2, 1.2, (b, ho, wo)) * (w - 1), 0, w - 1)
                          .astype(np.float32)).cuda()
    fy = torch.from_numpy(np.clip(rs.uniform(-0.2, 1.2, (b, ho, wo)) * (h - 1), 0, h - 1)
                          .astype(np.float32)).cuda()
    n5, n6 = sample.warp_bilinear.launches, sample.warp_bilinear_packed.launches
    got = sample.warp_bilinear(img, fx, fy)
    torch.cuda.synchronize()
    assert (sample.warp_bilinear.launches, sample.warp_bilinear_packed.launches) == (n5, n6 + 1)
    want = sample.warp_bilinear_plain(img.double(), fx.double(), fy.double())
    k5 = sample.warp_bilinear(img.float(), fx, fy)
    for g, w_, f in zip(got, want, k5):
        assert g.dtype == torch.float32 and _close(g, w_)
        assert (g - f).abs().max().item() <= 1e-6 * max(1.0, f.abs().max().item())


@pytest.mark.parametrize('c', [2, 3, 4])
def test_packed_warp_kernel_takes_a_misaligned_view(card, c):
    """Kernel 6 on a bfloat16 source that starts 2 bytes past a 4-byte
    boundary, as it lies: the same bits as kernel 5 on the widened source."""
    from slowtv_monodepth_tpu_torch.ops import sample
    rs = np.random.RandomState(c)
    b, h, w, ho, wo = 2, 19, 27, 23, 45
    flat = _rand(rs, b * h * w * c + 1).to(torch.bfloat16)
    img = flat[1:].view(b, h, w, c)
    assert img.is_contiguous() and img.data_ptr() % 4 == 2
    fx = torch.from_numpy(rs.uniform(0, w - 1, (b, ho, wo)).astype(np.float32)).cuda()
    fy = torch.from_numpy(rs.uniform(0, h - 1, (b, ho, wo)).astype(np.float32)).cuda()
    n6 = sample.warp_bilinear_packed.launches
    got = sample.warp_bilinear(img, fx, fy)
    torch.cuda.synchronize()
    assert sample.warp_bilinear_packed.launches == n6 + 1
    want = sample.warp_bilinear_plain(img.double(), fx.double(), fy.double())
    for g, w_, f in zip(got, want, sample.warp_bilinear(img.float(), fx, fy)):
        assert _close(g, w_) and torch.equal(g, f)


def test_warp_refuses_other_dtypes_on_the_card(card):
    from slowtv_monodepth_tpu_torch.ops import sample
    img = torch.zeros(1, 4, 4, 3, device='cuda', dtype=torch.float16)
    f = torch.zeros(1, 4, 4, device='cuda')
    with pytest.raises(TypeError):
        sample.warp_bilinear(img, f, f)


def test_grid_sample_bf16_source_gradients_on_the_card(card):
    """bf16 source through `grid_sample`: grid gradient, and the image's
    cotangent in bfloat16 (float32 scatter-add, cast back)."""
    from slowtv_monodepth_tpu_torch.ops import sample
    rs = np.random.RandomState(9)
    img = _rand(rs, 2, 9, 11, 3).to(torch.bfloat16).requires_grad_()
    grid = torch.from_numpy(rs.uniform(-1.1, 1.1, (2, 6, 7, 2)).astype(np.float32)).cuda()
    grid.requires_grad_()
    g = _rand(rs, 2, 6, 7, 3)
    sample.grid_sample(img, grid).backward(g)
    ref_img = img.detach().double().requires_grad_()
    ref_grid = grid.detach().double().requires_grad_()
    sample.grid_sample(ref_img, ref_grid, kernels=False).backward(g.double())
    assert img.grad.dtype == torch.bfloat16
    assert (img.grad.double() - ref_img.grad).abs().max().item() <= 2 ** -7 * max(
        1.0, ref_img.grad.abs().max().item())
    assert _close(grid.grad, ref_grid.grad)


@pytest.mark.parametrize('b,h,w,c,ho,wo', [(2, 24, 160, 3, 16, 200), (1, 16, 128, 1, 16, 128),
                                           (3, 37, 53, 3, 37, 53), (1, 5, 7, 8, 9, 4),
                                           # C = 4; the kernel's runs of 512 pixels: one
                                           # run, two, two and a part, a part
                                           (1, 16, 32, 4, 16, 32), (2, 20, 30, 3, 16, 64),
                                           (1, 21, 29, 3, 23, 45), (1, 5, 7, 4, 33, 31),
                                           # the generic C at the feature widths (ResNet-18's
                                           # and ConvNeXt-B's stride-4 maps)
                                           (2, 48, 160, 64, 48, 160), (2, 24, 40, 128, 23, 45)])
def test_warp_kernel_matches_plain(card, b, h, w, c, ho, wo):
    from slowtv_monodepth_tpu_torch.ops import sample
    rs = np.random.RandomState(6)
    img = _rand(rs, b, h, w, c)
    fx = torch.from_numpy(np.clip(rs.uniform(-0.2, 1.2, (b, ho, wo)) * (w - 1), 0, w - 1)
                          .astype(np.float32)).cuda()
    fy = torch.from_numpy(np.clip(rs.uniform(-0.2, 1.2, (b, ho, wo)) * (h - 1), 0, h - 1)
                          .astype(np.float32)).cuda()
    n = sample.warp_bilinear.launches
    got = sample.warp_bilinear(img, fx, fy)
    torch.cuda.synchronize()
    assert sample.warp_bilinear.launches == n + 1
    for g, want in zip(got, sample.warp_bilinear_plain(img.double(), fx.double(), fy.double())):
        assert _close(g, want)


@pytest.mark.parametrize('m,h,w,c,ties', [(3, 16, 24, 3, False), (2, 8, 13, 3, True),
                                          (1, 104, 40, 1, False), (2, 37, 70, 3, True),
                                          (1, 2, 2, 3, False),
                                          # kernel 8's tile edges (62 columns, 4-16 rows):
                                          # h = 2, w = 2, two and three tiles wide
                                          (2, 2, 67, 3, True), (1, 35, 2, 2, False),
                                          (1, 17, 125, 1, True), (2, 33, 124, 3, True),
                                          # kernel 7's tile edges (128 columns, 6
                                          # rows): C = 4, one past a tile, on two
                                          (2, 7, 129, 4, True), (1, 12, 256, 3, False),
                                          (1, 17, 385, 4, True), (1, 6, 128, 2, True)])
def test_photo_kernels_match_plain(card, m, h, w, c, ties):
    from slowtv_monodepth_tpu_torch.ops import photo
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32)).cuda()
    y = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32)).cuda()
    if ties:
        y[:, :, : w // 2] = x[:, :, : w // 2]
    g = torch.from_numpy(rs.rand(m, h, w).astype(np.float32)).cuda()
    n = (photo.photo_fwd.launches, photo.photo_bwd.launches)
    out = photo.photo_fwd(x, y, 0.85)
    dx, dy = photo.photo_bwd(x, y, g, 0.85)
    torch.cuda.synchronize()
    assert (photo.photo_fwd.launches, photo.photo_bwd.launches) == (n[0] + 1, n[1] + 1)
    xd, yd, gd = x.double(), y.double(), g.double()
    assert _close(out, photo.photo_fwd_plain(xd, yd, 0.85))
    for got, want in zip((dx, dy), photo.photo_bwd_plain(xd, yd, gd, 0.85)):
        assert _close(got, want)


@pytest.mark.parametrize('rows', [4, 16])
def test_photo_bwd_every_tile_height_is_bitwise_repeatable(card, rows):
    """Kernel 8's C entry on each tile height the plan may pick: within
    ATOL of the plain version in float64, two calls giving the same bits."""
    from slowtv_monodepth_tpu_torch import _build
    from slowtv_monodepth_tpu_torch.ops import photo
    rs = np.random.RandomState(8)
    m, h, w, c = 2, 37, 130, 3
    x = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32)).cuda()
    y = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32)).cuda()
    y[:, :, : w // 2] = x[:, :, : w // 2]
    g = torch.from_numpy(rs.rand(m, h, w).astype(np.float32)).cuda()

    def call():
        dx, dy = torch.empty_like(x), torch.empty_like(y)
        _build.check(_build.load().slowtv_photo_bwd_f32(
            x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(), m, h, w, c,
            0.85 / c, 0.15 / c, rows, 0, torch.cuda.current_stream().cuda_stream), 'kernel 8')
        return dx, dy
    first, second = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    for got, want in zip(first, photo.photo_bwd_plain(x.double(), y.double(), g.double(), 0.85)):
        assert _close(got, want)


@pytest.mark.parametrize('c', [1, 3, 4])
def test_photo_fwd_is_bitwise_repeatable_and_exact_at_ties(card, c):
    """Kernel 7 three tiles wide and five high: within ATOL of the plain
    version in float64, two calls the same bits, S == 0 exactly at ties."""
    from slowtv_monodepth_tpu_torch.ops import photo
    rs = np.random.RandomState(9)
    m, h, w = 2, 37, 260
    x = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32)).cuda()
    y = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32)).cuda()
    y[:, :, : w // 2] = x[:, :, : w // 2]
    first, second = (photo.photo_fwd(x, y, 0.85) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _close(first, photo.photo_fwd_plain(x.double(), y.double(), 0.85))
    assert (first[:, :, : w // 2 - 1] == 0).all()  # windows in the tie half: S == 0 exactly


def test_photo_division_by_a_constant_is_the_ieee_quotient(card):
    """Kernel 7's divisions by 9 and by C (`div_rn` of csrc/photo_common.cuh)
    give the IEEE quotient's bits for every float but NaN."""
    from slowtv_monodepth_tpu_torch.tools import photo_bench
    assert photo_bench.division_mismatches() == {d: 0 for d in photo_bench.DIVISORS}


def test_photo_kernels_take_one_to_four_channels_on_the_card(card):
    from slowtv_monodepth_tpu_torch.ops import photo
    x = torch.rand(1, 8, 8, 5, device='cuda')
    with pytest.raises(ValueError, match='photo_fwd takes 1 to 4 channels'):
        photo.photo_fwd(x, x, 0.85)
    with pytest.raises(ValueError, match='photo_bwd takes 1 to 4 channels'):
        photo.photo_bwd(x, x, torch.rand(1, 8, 8, device='cuda'), 0.85)
    assert photo.photo_fwd(x.cpu(), x.cpu(), 0.85).shape == (1, 8, 8)  # the plain version: any C


# ------------------------------------------------------------ fused ConvNeXt block
def _block_args(rs, b, h, w, c):
    return [_rand(rs, b, h, w, c), _rand(rs, c, 1, 7, 7, scale=1 / 7), _rand(rs, c, scale=0.1),
            1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1),
            _rand(rs, 4 * c, c, scale=c ** -0.5), _rand(rs, 4 * c, scale=0.1),
            _rand(rs, c, 4 * c, scale=(4 * c) ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.5)]


@pytest.mark.parametrize('approximate', [False, True], ids=['erf', 'tanh'])
@pytest.mark.parametrize('b,h,w,c', [(2, 12, 16, 128), (1, 5, 7, 96), (2, 37, 53, 160),
                                     (1, 3, 4, 40), (3, 9, 9, 264), (1, 7, 11, 1536),
                                     (1, 1, 1, 8), (2, 24, 40, 512), (4, 24, 40, 512),
                                     (1, 24, 40, 512), (1, 12, 20, 1024), (4, 12, 20, 1024)])
def test_convnext_block_kernel_matches_plain(card, b, h, w, c, approximate):
    """Kernel 9 against the unfused block in float64: heights under the 7x7
    halo, pixel counts off the 128-pixel tile and off 4, channels off 128, on
    the plan `fwd_plan` makes for this card (at the few-pixel deep stages of a
    request the blocks of a cluster split a product's K); two calls give the
    same bits."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
    args = _block_args(np.random.RandomState(10), b, h, w, c)
    n = cb.fused_convnext_block.launches
    out = cb.fused_convnext_block(*args, approximate=approximate)
    again = cb.fused_convnext_block(*args, approximate=approximate)
    torch.cuda.synchronize()
    assert cb.fused_convnext_block.launches == n + 2
    assert out.data_ptr() != args[0].data_ptr() and torch.equal(out, again)
    assert _close(out, cb.fused_convnext_block_plain(*_f64(*args), approximate=approximate))


def test_convnext_block_plan_splits_the_deep_stages_of_a_request(card):
    """The shapes above cover both kinds of plan on this card: split K at the
    last stage of a B=1 request, no split at the third stage at B=4."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
    from slowtv_monodepth_tpu_torch.ops.dwconv import _sm_count
    sms, slots = _sm_count(0), cb._cluster_blocks(0)
    assert all(0 < n <= sms for n in slots)
    assert max(cb.fwd_plan(1, 12, 20, 1024, sms, slots)[1:]) > 1
    assert cb.fwd_plan(4, 24, 40, 512, sms, slots)[1:] == (1, 1)


def test_convnext_block_under_grad_on_the_card_keeps_autograd(card):
    """Under grad the card runs the autograd Function: kernel 9 forward, kernel
    10 and kernels 1 and 2 backward; never a tensor without a grad_fn, and
    None for an input that asks for no gradient."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb, dwconv
    args = _block_args(np.random.RandomState(11), 1, 6, 8, 32)
    for i in (0, 5, 9):
        args[i].requires_grad_()
    n = (cb.fused_convnext_block.launches, cb.fused_convnext_block_bwd.launches,
         dwconv.depthwise_conv.launches, dwconv.dwconv_dw.launches)
    out = cb.fused_convnext_block(*args)
    assert out.grad_fn is not None
    dy = torch.randn_like(out)
    got = torch.autograd.grad(out, [args[i] for i in (0, 5, 9)], dy)
    assert (cb.fused_convnext_block.launches, cb.fused_convnext_block_bwd.launches,
            dwconv.depthwise_conv.launches, dwconv.dwconv_dw.launches) == (
        n[0] + 1, n[1] + 1, n[2] + 1, n[3] + 1)
    want = cb.fused_convnext_block_bwd_plain(*_f64(args[0].detach(), dy, *(
        t.detach() for t in args[1:])))
    for g, i in zip(got, (0, 5, 9)):
        assert _close(g, want[i])
    with torch.no_grad():
        out = cb.fused_convnext_block(*args)  # serving
    assert out.grad_fn is None
    assert _close(out, cb.fused_convnext_block_plain(*_f64(*(t.detach() for t in args))))


# Ragged and step shapes, then the plan's tile edges: pixel counts one short
# of and one past the products' 128-pixel tile and the 256-pixel chain,
# channels one quad short of and past a 128-column tile.
BLOCK_BWD_CASES = [(2, 12, 16, 128), (1, 5, 7, 96), (2, 37, 53, 160), (1, 3, 4, 40),
                   (3, 9, 9, 264), (1, 7, 11, 1024), (1, 1, 1, 8), (2, 24, 40, 512),
                   (8, 12, 20, 192), (1, 1, 127, 132), (1, 3, 43, 124), (1, 1, 255, 64),
                   (1, 257, 1, 40)]


@pytest.mark.parametrize('approximate', [False, True], ids=['erf', 'tanh'])
@pytest.mark.parametrize('b,h,w,c', BLOCK_BWD_CASES)
def test_convnext_block_backward_kernel_matches_plain(card, b, h, w, c, approximate):
    """Kernel 10 + kernels 1 and 2 against the plain backward in float64, each
    of the ten gradients relative to its own largest magnitude; twice on the
    same inputs, bitwise the same."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
    rs = np.random.RandomState(13)
    args = _block_args(rs, b, h, w, c)
    dy = _rand(rs, b, h, w, c)
    n = cb.fused_convnext_block_bwd.launches
    got = cb.fused_convnext_block_bwd(args[0], dy, *args[1:], approximate=approximate)
    again = cb.fused_convnext_block_bwd(args[0], dy, *args[1:], approximate=approximate)
    torch.cuda.synchronize()
    assert cb.fused_convnext_block_bwd.launches == n + 2
    want = cb.fused_convnext_block_bwd_plain(*_f64(args[0], dy, *args[1:]),
                                             approximate=approximate)
    for g, a, t in zip(got, again, want):
        assert g.shape == t.shape and torch.equal(g, a)
        assert (g - t).abs().max().item() <= ATOL * t.abs().max().item()


def test_convnext_block_backward_refuses_what_it_cannot_take(card):
    """More channels than the block takes, and a cotangent that is not
    contiguous: errors, no launch."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
    n = cb.fused_convnext_block_bwd.launches
    args = _block_args(np.random.RandomState(14), 1, 2, 3, cb.MAX_CHANNELS + 4)
    with pytest.raises(ValueError, match=str(cb.MAX_CHANNELS)):
        cb.fused_convnext_block_bwd(args[0], torch.ones_like(args[0]), *args[1:])
    args = _block_args(np.random.RandomState(14), 1, 4, 4, 8)
    with pytest.raises(ValueError, match='contiguous'):
        cb.fused_convnext_block_bwd(args[0], torch.ones(1, 8, 4, 4, device='cuda').permute(
            0, 2, 3, 1), *args[1:])
    assert cb.fused_convnext_block_bwd.launches == n


def test_convnext_block_takes_a_view_that_starts_off_alignment(card):
    """x and the fc weights one float into their storage (not 16-byte
    aligned): the kernel reads them a float at a time (its 16-byte reads are
    of its own scratch)."""
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
    rs = np.random.RandomState(12)
    args = _block_args(rs, 1, 10, 12, 32)

    def off(t):
        return torch.empty(t.numel() + 1, device='cuda')[1:].view(t.shape).copy_(t)
    x, w1, w2 = off(args[0]), off(args[5]), off(args[7])
    assert x.data_ptr() % 16 and w1.data_ptr() % 16 and x.is_contiguous()
    out = cb.fused_convnext_block(x, *args[1:5], w1, args[6], w2, *args[8:])
    torch.cuda.synchronize()
    assert _close(out, cb.fused_convnext_block_plain(*_f64(*args)))


def test_depthnet_fused_blocks_match_plain_path_in_float64(card):
    from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
    from slowtv_monodepth_tpu_torch.ops import convnext_block as cb, decoder_stage, dwconv
    cfg = dict(enc_name='convnext_atto', out_scales=(0, 1, 2, 3))
    fused_net, plain_net = DepthNet(**cfg, fused_blocks=True), DepthNet(**cfg, kernels=False)
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(fused_net, 0).items()}
    for net in (fused_net, plain_net):
        net.load_state_dict(sd)
    fused_net, plain_net = fused_net.cuda().eval(), plain_net.double().cuda().eval()
    x = _rand(np.random.RandomState(2), 2, 3, 64, 96)
    n = (cb.fused_convnext_block.launches, dwconv.depthwise_conv.launches,
         decoder_stage.fused_upconv_stage.launches)
    with torch.no_grad():
        got, want = fused_net(x)['disp'], plain_net(x.double())['disp']
    assert (cb.fused_convnext_block.launches, dwconv.depthwise_conv.launches,
            decoder_stage.fused_upconv_stage.launches) == (n[0] + 12, n[1], n[2] + 2)
    for s in range(4):
        assert _close(got[s], want[s])
    # Under grad: every parameter's gradient against the plain path in float64.
    n = (cb.fused_convnext_block.launches, cb.fused_convnext_block_bwd.launches)
    sum(d.sum() for d in fused_net(x)['disp'].values()).backward()
    sum(d.sum() for d in plain_net(x.double())['disp'].values()).backward()
    assert (cb.fused_convnext_block.launches, cb.fused_convnext_block_bwd.launches) == (
        n[0] + 12, n[1] + 12)
    for (k, p), q in zip(fused_net.named_parameters(), plain_net.parameters()):
        assert p.grad is not None and _close(p.grad, q.grad), k
