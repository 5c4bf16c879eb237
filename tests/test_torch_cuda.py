"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the serving path launching them. Every test here is marked
``cuda`` and skips without a card. The file imports no jax, so with the
JAX harness in conftest.py left out it runs on a machine that has only
PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu_torch.ops import topk as T
from oryx_tpu_torch.ops.transfer import quantize_rows_int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _inputs(dtype, dev, n=20000, f=50, b=37, dup=1):
    g = torch.Generator().manual_seed(0)
    y = torch.randn(-(-n // dup), f, generator=g).repeat_interleave(dup, 0)[:n]
    xs = torch.randn(b, f, generator=g)
    scales = None
    if dtype == torch.int8:
        q, s = quantize_rows_int8(y.numpy())
        y, scales = torch.from_numpy(q), torch.from_numpy(s).to(dev)
    else:
        y, xs = y.to(dtype), xs.to(dtype)
    return xs.to(dev), y.contiguous().to(dev), scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n,f,b,k,dup", [
    (20000, 50, 37, 18, 1), (777, 33, 13, 5, 1), (6, 16, 4, 10, 1),
    (3000, 16, 7, 25, 5), (5000, 250, 3, 128, 1),
])
def test_kernels_match_plain_versions(cuda_device, dtype, n, f, b, k, dup):
    xs, y, scales = _inputs(dtype, cuda_device, n, f, b, dup)
    T.reset_launches()
    v, i = T.topk_dot_batch_cuda(xs, y, k=k, scales=scales)
    torch.cuda.synchronize()
    assert T.LAUNCHES == {"topk_dot_partial": 1, "topk_merge": 1}
    v_r, i_r = T.topk_dot_batch_reference(xs, y, k=k, scales=scales)
    if dtype == torch.int8:
        assert torch.equal(v, v_r) and torch.equal(i, i_r)
    else:
        torch.testing.assert_close(v, v_r, atol=1e-3, rtol=1e-3)
        assert (i == i_r).float().mean().item() > 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("f", [50, 33])
def test_kernel_reads_a_row_offset_view(cuda_device, dtype, f):
    # y[1:] starts one row into its storage: aligned to the row's own
    # width (2 or 1 bytes for odd rows), not to 16 bytes
    xs, y, scales = _inputs(dtype, cuda_device, n=3001, f=f, b=9)
    y = y[1:]
    scales = scales[1:] if scales is not None else None
    v, i = T.topk_dot_batch_cuda(xs, y, k=16, scales=scales)
    v_r, i_r = T.topk_dot_batch_reference(xs, y, k=16, scales=scales)
    if dtype == torch.int8:
        assert torch.equal(v, v_r) and torch.equal(i, i_r)
    else:
        torch.testing.assert_close(v, v_r, atol=1e-3, rtol=1e-3)
        assert (i == i_r).float().mean().item() > 0.99


def test_merge_kernel_is_bit_identical(cuda_device):
    xs, y, _ = _inputs(torch.bfloat16, cuda_device, n=9000, dup=3)
    n_splits, split_len = T.plan_splits(xs.shape[0], y.shape[0], 132)
    pv, pi = T.topk_dot_partial(xs, y, kb=32, n_splits=n_splits,
                                split_len=split_len)
    v, i = T.topk_merge(pv, pi, k=20)
    v_r, i_r = T.topk_merge_reference(pv, pi, k=20)
    assert torch.equal(v, v_r) and torch.equal(i, i_r)


def test_serving_path_launches_the_kernels(cuda_device):
    from oryx_tpu_torch.apps.als.serving import ALSServingModel
    from oryx_tpu_torch.apps.als.state import state_from_arrays

    rng = np.random.default_rng(1)
    y = rng.standard_normal((5000, 12)).astype(np.float32)
    state = state_from_arrays(12, True, [], np.zeros((0, 12), np.float32),
                              [f"i{j}" for j in range(5000)], y)
    for mode in ("exact", "quantized"):
        model = ALSServingModel(state, score_mode=mode)
        try:
            xu = rng.standard_normal(12).astype(np.float32)
            model.top_n(xu, 5)  # builds the view
            T.reset_launches()
            got = [i for i, _ in model.top_n(xu, 5)]
            assert T.LAUNCHES == {"topk_dot_partial": 1, "topk_merge": 1}
            want = [f"i{j}" for j in np.argsort(-(y @ xu), kind="stable")[:5]]
            assert got == want
        finally:
            model.close()


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    xs, y, _ = _inputs(torch.float32, cuda_device)
    with pytest.raises(ValueError):
        T.topk_dot_batch_cuda(xs.to(torch.bfloat16), y, k=5)  # mixed types
    with pytest.raises(ValueError):
        T.topk_dot_partial(xs, y[:, :10].contiguous(), kb=8, n_splits=1,
                           split_len=20096)  # shape mismatch
