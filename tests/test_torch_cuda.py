"""Tests of the port's hand-written CUDA kernels, which have no CPU mode.

Each skips where no CUDA device is present. On a machine with the card
(where JAX need not be installed) run them without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest

torch = pytest.importorskip("torch")

from person_capture_tpu_torch.kernels import hdr as H  # noqa: E402

ALGOS = ["clip", "reinhard", "mobius", "hable", "bt.2390"]
# largest share of pixels in which the fused entry may differ from its plain
# version (chip_smoke.DIFFER_LIMIT): a sound kernel differs in about 0.2 %
# of them, one that drops the dither, transposes the Bayer tile or
# truncates in 12 to 90 %
DIFFER_LIMIT = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("desat", [0.0, 0.25])
@pytest.mark.parametrize("algo", ALGOS)
def test_tonemap_kernel_matches_plain_version(cuda, algo, desat):
    """atol 2e-3: accurate powf on both sides, summed in another order."""
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.rand(3, 270, 481, device=cuda, generator=g)
    before = H.TONEMAP_LAUNCHES.count
    got = H.tonemap_planes(x, 1000.0, 100.0, algo, desat, 0.4)
    want = H.tonemap_planes_reference(x, 1000.0, 100.0, algo, desat, 0.4)
    torch.cuda.synchronize()
    assert H.TONEMAP_LAUNCHES.count == before + 1
    assert float((got - want).abs().max()) <= 2e-3


@pytest.mark.cuda
def test_tonemap_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.rand(3, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        H.tonemap_planes(x.double())
    with pytest.raises(ValueError, match=r"\[3, H, W\]"):
        H.tonemap_planes(x[:2])
    with pytest.raises(ValueError, match="contiguous"):
        H.tonemap_planes(x.transpose(1, 2))


def _p010_cuda(h, w, seed):
    """Seeded random P010 planes (10-bit codes in the high bits, the full
    code range) as the int16 CUDA tensors plane_tensor makes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1024, (h, w)).astype(np.uint16) << 6
    uv = rng.integers(0, 1024, (h // 2, w // 2, 2)).astype(np.uint16) << 6
    return H.plane_tensor(y, "cuda"), H.plane_tensor(uv, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("desat", [0.0, 0.25])
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_kernel_matches_plain_version(cuda, algo, desat, dither,
                                            full_range):
    """≤ 1 LSB (one rounding step), in at most DIFFER_LIMIT of the pixels,
    at an even size whose width is not a multiple of 4, so the per-pixel
    path and its masked tail run; one launch on the counter per call."""
    y, uv = _p010_cuda(270, 482, seed=1)
    args = (full_range, 1000.0, 100.0, algo, desat, 0.4, dither)
    before = H.HDR_TO_SDR_LAUNCHES.count
    got = H.hdr_to_sdr_bgr(y, uv, full_range, "pq", *args[1:])
    want = H.hdr_to_sdr_bgr_reference(y, uv, *args)
    torch.cuda.synchronize()
    assert H.HDR_TO_SDR_LAUNCHES.count == before + 1
    assert got.shape == (270, 482, 3) and got.dtype == torch.uint8
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff.amax(dim=-1) > 0).float().mean()) <= DIFFER_LIMIT


@pytest.mark.cuda
def test_fused_kernel_vector_path_matches_plain_version(cuda):
    """Width a multiple of 4: 8-byte Y loads and 32-bit BGR stores."""
    y, uv = _p010_cuda(64, 256, seed=2)
    got = H.hdr_to_sdr_bgr(y, uv, algo="auto", desat=0.25, param=0.4)
    want = H.hdr_to_sdr_bgr_reference(y, uv, algo="auto", desat=0.25,
                                      param=0.4)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff.amax(dim=-1) > 0).float().mean()) <= DIFFER_LIMIT


@pytest.mark.cuda
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    y, uv = _p010_cuda(8, 16, seed=3)
    with pytest.raises(ValueError, match="even"):
        H.hdr_to_sdr_bgr(y[:7], uv[:3])
    with pytest.raises(ValueError, match="even"):
        H.hdr_to_sdr_bgr(y[:, :15].contiguous(), uv[:, :7].contiguous())
    with pytest.raises(ValueError, match="int16"):
        H.hdr_to_sdr_bgr(y.int(), uv)
    with pytest.raises(ValueError, match="contiguous"):
        H.hdr_to_sdr_bgr(y[:, ::2], uv)
    with pytest.raises(ValueError, match=r"\[H/2, W/2, 2\]"):
        H.hdr_to_sdr_bgr(y, uv[:2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        H.hdr_to_sdr_bgr_cuda(y, uv.cpu())
