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
from oryx_tpu_torch.ops.transfer import is_pitched, quantize_rows_int8, to_pitched

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _inputs(dtype, dev, n=20000, f=50, b=37, dup=1):
    """(xs, pitched y, scales) on ``dev``: the item view as ops/transfer.py
    lays it out on the card."""
    g = torch.Generator().manual_seed(0)
    y = torch.randn(-(-n // dup), f, generator=g).repeat_interleave(dup, 0)[:n]
    xs = torch.randn(b, f, generator=g)
    scales = None
    if dtype == torch.int8:
        q, s = quantize_rows_int8(y.numpy())
        y, scales = torch.from_numpy(q), torch.from_numpy(s).to(dev)
    else:
        y, xs = y.to(dtype), xs.to(dtype)
    return xs.to(dev), to_pitched(y.contiguous().to(dev)), scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n,f,b,k,dup", [
    (20000, 50, 37, 18, 1), (777, 33, 13, 5, 1), (6, 16, 4, 10, 1),
    (3000, 16, 7, 25, 5), (5000, 250, 3, 128, 1),
    (20000, 50, 1, 10, 1), (20000, 250, 64, 128, 1), (20000, 50, 2047, 32, 1),
    (50000, 16, 37, 25, 5),  # ties within a tile across a mid-tile flush
    (5000, 150, 9, 20, 1),   # a row of 3 chunks (bf16), the last one partial
    # wide rows stream through a ring of fewer stages than a tile's chunks
    (20000, 400, 64, 128, 1), (20000, 600, 37, 128, 1),
    (5000, 1024, 9, 128, 1),  # the widest bf16 rows at kb=128: 2 stages
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
    # y[1:] starts one row into a pitched buffer: still 16-byte aligned at
    # the same pitch, so the kernel reads it in place
    xs, y, scales = _inputs(dtype, cuda_device, n=3001, f=f, b=9)
    y = y[1:]
    assert is_pitched(y)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_unpitched_item_view_raises(cuda_device, dtype):
    # a dense [n, 50] view (a 200-, 100- or 50-byte row stride) and a view
    # that starts one element into a pitched buffer are refused, never
    # copied
    xs, y, scales = _inputs(dtype, cuda_device, n=3000, f=50, b=5)
    if dtype == torch.int8:
        xs = T.quantize_queries(xs)[0]
    kw = {"kb": 8, "n_splits": 1, "split_len": 3072, "scales": scales}
    dense = y.contiguous()
    assert not is_pitched(dense)
    T.reset_launches()
    with pytest.raises(ValueError, match="to_pitched"):
        T.topk_dot_partial(xs, dense, **kw)
    shifted = y.as_strided(y.shape, y.stride(), y.storage_offset() + 1)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="to_pitched"):
        T.topk_dot_partial(xs, shifted, **kw)
    assert T.LAUNCHES["topk_dot_partial"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("f", [16, 50, 250])
@pytest.mark.parametrize("kb", [16, 32, 128])
def test_shared_memory_budget_of_the_library(cuda_device, dtype, f, kb):
    # the library's own plan: a block within the card's shared memory, at
    # least one resident per SM, and these widths within its limit
    itemsize = torch.empty((), dtype=dtype).element_size()
    props = torch.cuda.get_device_properties(cuda_device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    lib = T._lib()
    smem = lib.oryx_topk_partial_smem_bytes(f, kb, itemsize)
    assert 0 < smem <= limit
    assert lib.oryx_topk_partial_blocks_per_sm(f, kb, itemsize) >= 1
    assert T.max_features(kb, dtype) >= f
    widest = T.max_features(kb, dtype)
    assert lib.oryx_topk_partial_smem_bytes(widest, kb, itemsize) <= limit
    assert lib.oryx_topk_partial_smem_bytes(widest + 1, kb, itemsize) > limit


def test_serving_shape_keeps_four_blocks_per_sm(cuda_device):
    # B=512, F=50, kb=32 in bf16 and int8: 4 blocks (16 warps) per SM
    for itemsize in (2, 1):
        assert T._lib().oryx_topk_partial_blocks_per_sm(50, 32, itemsize) == 4


def test_width_limit_is_checked_when_the_model_is_built(cuda_device):
    # bf16 rows up to 1,024 features and int8 up to 2,048 at every k; a
    # wider model fails once, when it is built, and a wider partial launch
    # raises before it reaches the kernel
    from oryx_tpu_torch.apps.als.serving import ALSServingModel
    from oryx_tpu_torch.apps.als.state import ALSState

    assert T.max_features(T.MAX_K, torch.bfloat16) >= 1024
    assert T.max_features(T.MAX_K, torch.int8) >= 2048
    T.check_features(1024, torch.bfloat16)
    wide = T.max_features(T.MAX_K, torch.bfloat16) + 1
    for mode in ("exact", "quantized"):
        f = wide if mode == "exact" else T.max_features(T.MAX_K, torch.int8) + 1
        with pytest.raises(ValueError, match="features"):
            ALSServingModel(ALSState(f, True), score_mode=mode)
    xs, y, _ = _inputs(torch.bfloat16, cuda_device, n=300, f=wide, b=3)
    T.reset_launches()
    with pytest.raises(ValueError, match="features"):
        T.topk_dot_partial(xs, y, kb=128, n_splits=1, split_len=320)
    assert T.LAUNCHES["topk_dot_partial"] == 0
