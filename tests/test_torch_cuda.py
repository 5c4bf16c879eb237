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
        _close(v, v_r, dtype, f)
        assert (i == i_r).float().mean().item() > 0.99


def _close(v, v_r, dtype, f):
    """Float kernel values against the plain version's: bf16 within 1e-3
    (atol and rtol); f32 within two f32 drifts, absolute."""
    if dtype == torch.float32:
        torch.testing.assert_close(v, v_r, atol=2 * T.f32_tolerance(f), rtol=0)
    else:
        torch.testing.assert_close(v, v_r, atol=1e-3, rtol=1e-3)


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
        _close(v, v_r, dtype, f)
        assert (i == i_r).float().mean().item() > 0.99


def test_merge_kernel_is_bit_identical(cuda_device):
    xs, y, _ = _inputs(torch.bfloat16, cuda_device, n=9000, dup=3)
    n_splits, split_len = T.plan_splits(xs.shape[0], y.shape[0], 132)
    pv, pi = T.topk_dot_partial(xs, y, kb=32, n_splits=n_splits,
                                split_len=split_len)
    v, i = T.topk_merge(pv, pi, k=20)
    v_r, i_r = T.topk_merge_reference(pv, pi, k=20)
    assert torch.equal(v, v_r) and torch.equal(i, i_r)


def _sorted_partials(dev, s, b, kb, seed, levels=50):
    """[S, B, kb] partial lists as the partial kernel writes them: sorted by
    (value desc, index asc), indices distinct across lists, values from a
    few levels (heavy ties); every 7th list holds only a few real entries
    and ends in (-inf, -1) padding."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randint(0, levels, (s, b, kb), generator=g, device=dev).float()
    v = torch.sort(v, dim=-1, descending=True).values
    i = torch.randperm(s * kb, generator=g, device=dev).view(s, 1, kb)
    i = torch.sort(i, dim=-1).values.expand(s, b, kb).to(torch.int32).clone()
    for j in range(0, s, 7):
        v[j, :, j % kb:] = float("-inf")
        i[j, :, j % kb:] = -1
    return v.contiguous(), i


@pytest.mark.parametrize("s", [1, 2, 66, 521, 2000])
@pytest.mark.parametrize("b", [1, 5, 512])
@pytest.mark.parametrize("k,kb", [(1, 2), (10, 16), (32, 64), (100, 128),
                                  (128, 128)])
def test_merge_matches_plain_version(cuda_device, s, b, k, kb):
    pv, pi = _sorted_partials(cuda_device, s, b, kb, seed=s * b + k)
    T.reset_launches()
    v, i = T.topk_merge(pv, pi, k=k)
    torch.cuda.synchronize()
    assert T.LAUNCHES["topk_merge"] == 1
    v_r, i_r = T.topk_merge_reference(pv, pi, k=k)
    assert torch.equal(v, v_r) and torch.equal(i, i_r)


@pytest.mark.parametrize("s,k,kb", [(66, 64, 64), (521, 128, 128),
                                    (2000, 128, 128), (521, 10, 16)])
@pytest.mark.parametrize("layout", ["interleaved", "padding"])
def test_merge_general_path_is_exact(cuda_device, s, k, kb, layout):
    # more entries meet the merge's bound than it sorts in shared memory.
    # "interleaved": lists 0..k-2 hold items j, j + k - 1, j + 2 (k - 1), ...
    # at one value, list k-1 a worse run of the same value, the rest lower
    # values; the bound is then about (k-1)^2 entries deep (k=10: 82, still
    # in shared memory). "padding": only the first 3 lists hold one real
    # entry, the rest is (-inf, -1), which is then the bound itself.
    b = 3
    dev = cuda_device
    pos = torch.arange(kb, device=dev)
    if layout == "interleaved":
        pv = torch.zeros((s, b, kb), device=dev)
        pv[:k] = 1.0
        lists = torch.arange(s, device=dev)[:, None]
        idx = torch.where(lists < k - 1, lists + pos * (k - 1),
                          1_000_000 + lists * kb + pos)
        pi = idx[:, None, :].expand(s, b, kb).to(torch.int32).contiguous()
    else:
        pv = torch.full((s, b, kb), float("-inf"), device=dev)
        pi = torch.full((s, b, kb), -1, dtype=torch.int32, device=dev)
        pv[:3, :, 0] = torch.tensor([2.0, 1.0, 2.0], device=dev)[:, None]
        pi[:3, :, 0] = torch.tensor([7, 3, 5], dtype=torch.int32,
                                    device=dev)[:, None]
    v, i = T.topk_merge(pv, pi, k=k)
    v_r, i_r = T.topk_merge_reference(pv, pi, k=k)
    assert torch.equal(v, v_r) and torch.equal(i, i_r)


def _near_tie_agree(v, i, v_r, i_r, true_score, tol):
    """f32 kernel output against its plain version: values within 2 tol
    (absolute), -inf padding identical, and where an index differs the
    kernel's item truly (float64) scores within 2 tol of the plain
    version's value at that slot."""
    torch.testing.assert_close(v, v_r, atol=2 * tol, rtol=0)
    pad = torch.isinf(v_r)
    assert torch.equal(torch.isinf(v), pad) and torch.equal(i[pad], i_r[pad])
    where = (i != i_r).nonzero(as_tuple=True)
    if where[0].numel():
        gap = (true_score(where[-2], i[where]) - v_r[where].double()).abs()
        assert bool((gap <= 2 * tol).all())


def _err_vs_f64(v, i, true_score):
    """Largest distance of the finite values [B, k] from the float64 scores
    of the items they name."""
    fin = ~torch.isinf(v)
    rows = torch.arange(v.shape[0], device=v.device)[:, None].expand_as(v)
    return (v[fin].double() - true_score(rows[fin], i[fin])).abs().max().item()


@pytest.mark.parametrize("f", [1, 16, 33, 50, 250, 600, "widest"])
@pytest.mark.parametrize("b", [1, 13, 64, 65, 512])
def test_f32_partial_matches_plain_version(cuda_device, f, b):
    # the f32 partial kernel (FMA in wgmma's accumulator layout over TMA
    # tiles; past ~450 features the queries stream through the ring) and
    # the whole call, against their plain versions
    if f == "widest":
        f = T.max_features(T.MAX_K, torch.float32)
    n = 20000 if f <= 600 else 1000
    xs, y, _ = _inputs(torch.float32, cuda_device, n=n, f=f, b=b)
    k = 100 if f >= 250 else 10
    kb = T._next_pow2(k)
    tol = T.f32_tolerance(f)
    yf = y.float()

    def true_score(rows, idx):
        return (xs[rows].double() * yf[idx.long()].double()).sum(dim=1)

    n_splits, split_len = T.launch_plan(b, y, kb)
    T.reset_launches()
    pv, pi = T.topk_dot_partial(xs, y, kb=kb, n_splits=n_splits,
                                split_len=split_len)
    torch.cuda.synchronize()
    assert T.LAUNCHES["topk_dot_partial"] == 1
    rv, ri = T.topk_dot_partial_reference(xs, y, kb=kb, n_splits=n_splits,
                                          split_len=split_len)
    _near_tie_agree(pv, pi, rv, ri, true_score, tol)
    v, i = T.topk_dot_batch_cuda(xs, y, k=k)
    v_r, i_r = T.topk_dot_batch_reference(xs, y, k=k)
    _near_tie_agree(v, i, v_r, i_r, true_score, tol)
    assert _err_vs_f64(v, i, true_score) <= tol


@pytest.mark.parametrize("f", [16, 50, 250, 600, "widest"])
def test_f32_tolerance_rejects_tf32(cuda_device, f):
    # the f32 checks tell full-f32 products from TF32 ones: the kernel's
    # values stay within f32_tolerance of their float64 scores, the plain
    # version's with TF32 switched on do not
    if f == "widest":
        f = T.max_features(T.MAX_K, torch.float32)
    n, b, k = (20000 if f <= 600 else 1000), 64, 32
    xs, y, _ = _inputs(torch.float32, cuda_device, n=n, f=f, b=b)

    def true_score(rows, idx):
        return (xs[rows].double() * y[idx.long()].double()).sum(dim=1)

    v, i = T.topk_dot_batch_cuda(xs, y, k=k)
    assert _err_vs_f64(v, i, true_score) <= T.f32_tolerance(f)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        v_t, i_t = torch.topk(xs @ y.T, k, dim=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert _err_vs_f64(v_t, i_t.to(torch.int32), true_score) > T.f32_tolerance(f)


def test_f32_queries_are_pitched_only_when_they_stream(cuda_device):
    # a resident f32 query block is staged with element loads at any row
    # pitch; only rows too wide for it stream their queries by TMA
    lib = T._lib()
    assert lib.oryx_topk_partial_streams_queries(50, 32, 4) == 0
    assert lib.oryx_topk_partial_streams_queries(
        T.max_features(128, torch.float32), 128, 4) == 1
    assert lib.oryx_topk_partial_streams_queries(1024, 128, 2) == 0
    xs, y, _ = _inputs(torch.float32, cuda_device, n=3000, f=50, b=9)
    assert not is_pitched(xs)  # a dense [9, 50] block: 200-byte rows
    pv, pi = T.topk_dot_partial(xs, y, kb=16, n_splits=1, split_len=3008)
    rv, ri = T.topk_dot_partial_reference(xs, y, kb=16, n_splits=1,
                                          split_len=3008)
    torch.testing.assert_close(pv, rv, atol=2 * T.f32_tolerance(50), rtol=0)


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
    pv = torch.zeros((3, 4, 16), device=cuda_device)
    pi = torch.zeros((3, 4, 16), dtype=torch.int32, device=cuda_device)
    T.reset_launches()
    with pytest.raises(ValueError):
        T.topk_merge(pv, pi, k=17)  # k > kb
    with pytest.raises(ValueError):
        T.topk_merge(pv, pi.long(), k=5)  # int64 indices
    with pytest.raises(ValueError):
        T.topk_merge(pv.transpose(0, 1), pi.transpose(0, 1), k=5)  # strided
    assert T.LAUNCHES["topk_merge"] == 0


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
    if dtype == torch.float32:
        # f32 streams its query block through the ring: every width fits,
        # up to the library's bound
        assert widest == 65535
    else:
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
    # f32: no narrower than the CUDA-core kernel before TMA (1,043 at kb=128)
    assert T.max_features(T.MAX_K, torch.float32) >= 1043
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


def test_serving_layer_on_the_card_answers_like_the_cpu(cuda_device, tmp_path):
    """The port's ServingLayer built from config (its ALS manager resolves
    the card), fed a MODEL-REF over mem:// topics, answers /recommend over
    HTTP like the same layer on the CPU. Both re-rank candidates in exact
    f32 on the host, so an id present in both answers at a slot carries the
    same value; ids may differ only where the card's bf16 candidate
    selection meets a near-tie (values within 1e-3, atol and rtol)."""
    import http.client
    import json
    import time

    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import get_broker
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.serving.batcher import TopKBatcher
    from oryx_tpu_torch.serving.server import ServingLayer

    rng = np.random.default_rng(11)
    n_items, n_users, f = 5000, 64, 32
    x = rng.standard_normal((n_users, f), dtype=np.float32)
    y = rng.standard_normal((n_items, f), dtype=np.float32)
    art = ModelArtifact(
        "als", content={"knownItems": {f"u{j}": [f"i{j}"] for j in range(n_users)}},
        tensors={"X": x, "Y": y})
    art.set_extension("features", str(f))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", [f"u{j}" for j in range(n_users)])
    art.set_extension("YIDs", [f"i{j}" for j in range(n_items)])
    art.write(tmp_path / "model")

    def get(port, path):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            c.request("GET", path, headers={"Accept": "application/json"})
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    layers = {}
    for where in ("card", "cpu"):
        bus = f"mem://cuda-serving-{where}"
        broker = get_broker(bus)
        for topic in ("OryxInput", "OryxUpdate"):
            broker.create_topic(topic, 1)
        overlay = dict(app_overlay("als"))
        overlay.update({"oryx.input-topic.broker": bus,
                        "oryx.update-topic.broker": bus,
                        "oryx.serving.api.port": 0,
                        "oryx.serving.api.loops": 2,
                        "oryx.monitoring.flight.dir":
                            str(tmp_path / f"flight-{where}")})
        config = load_config(overlay=overlay)
        manager = (None if where == "card"
                   else ALSServingModelManager(config, device="cpu"))
        layers[where] = ServingLayer(config, model_manager=manager)
        layers[where].start()
        broker.send("OryxUpdate", "MODEL-REF", str(tmp_path / "model"))
    try:
        for sl in layers.values():
            deadline = time.monotonic() + 120
            while get(sl.port, "/ready")[0] != 200:
                assert time.monotonic() < deadline, "never ready"
                time.sleep(0.05)
        view = layers["card"].model_manager.get_model()._device_view[0]
        assert view.device.type == "cuda"
        b = TopKBatcher.shared()
        d0 = b.dispatches
        T.reset_launches()
        answers, launches = {}, {}
        for where, sl in layers.items():
            answers[where] = [get(sl.port, f"/recommend/u{j}?howMany=10")
                              for j in range(n_users)]
            launches[where] = (dict(T.LAUNCHES), b.dispatches - d0)
        card_launches, card_dispatches = launches["card"]
        assert card_launches["topk_dot_partial"] == card_dispatches > 0
        assert card_launches["topk_merge"] == card_dispatches
        # the CPU layer's dispatches run the plain versions
        assert launches["cpu"][0] == card_launches
    finally:
        for sl in layers.values():
            sl.close()
    for (cs, cb), (ps, pb) in zip(answers["card"], answers["cpu"]):
        assert cs == ps == 200
        card, cpu = json.loads(cb), json.loads(pb)
        assert len(card) == len(cpu) == 10
        for (ci, cv), (pi, pv) in zip(card, cpu):
            if ci == pi:
                assert cv == pytest.approx(pv, rel=1e-6)
            else:
                assert cv == pytest.approx(pv, rel=1e-3, abs=1e-3)


# ---------------------------------------------------------------------------
# ALS training and fold-in on the card (library ops; no hand kernel)
# ---------------------------------------------------------------------------

def _half_step_inputs(n=256, p=64, k=50, m=3000, seed=0, singular_row=None):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    idx = rng.integers(0, m, (n, p)).astype(np.int32)
    mask = (rng.random((n, p)) < 0.6).astype(np.float32)
    val = (rng.integers(1, 6, (n, p)) * mask).astype(np.float32)
    if singular_row is not None:  # a row of NaN strengths never solves
        val[singular_row] = np.nan
        mask[singular_row] = 1.0
    return f, idx, val, mask


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_half_step_on_the_card_matches_the_cpu(cuda_device, implicit, dtype, rtol):
    from oryx_tpu_torch.ops import als as A
    from oryx_tpu_torch.ops.vector import full_f32, gram

    f, idx, val, mask = _half_step_inputs()
    outs = []
    for dev in ("cpu", cuda_device):
        ft = torch.from_numpy(f).to(dev)
        with full_f32():
            x = A._half_step(
                ft, gram(ft), *(torch.from_numpy(a).to(dev) for a in (idx, val, mask)),
                0.01, 1.0, implicit, 64, compute_dtype=dtype,
            )
        assert x.dtype == torch.float32
        outs.append(x.cpu().numpy())
    cpu, card = outs
    scale = np.abs(cpu).max()
    np.testing.assert_allclose(card, cpu, rtol=rtol, atol=rtol * scale)


def test_bf16_normal_equations_use_f32_outputs(cuda_device):
    """bf16 inputs give f32 normal equations (products and sums in f32,
    TF32 off), equal to the CPU version's up to the order of the sums."""
    from oryx_tpu_torch.ops import als as A
    from oryx_tpu_torch.ops.vector import full_f32

    rng = np.random.default_rng(3)
    yu = torch.from_numpy(rng.standard_normal((8, 64, 16)).astype(np.float32))
    w = torch.from_numpy((rng.random((8, 64)) * 3).astype(np.float32))
    yu, w = yu.bfloat16(), w.bfloat16()
    with full_f32():
        card = A._weighted_gram(yu.cuda(), w.cuda())
        cpu = A._weighted_gram(yu, w)
        rhs = A._weighted_sum(yu.cuda(), w.cuda())
        rhs_cpu = A._weighted_sum(yu, w)
    assert card.dtype == cpu.dtype == rhs.dtype == torch.float32
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(rhs.cpu().numpy(), rhs_cpu.numpy(), rtol=1e-5, atol=1e-4)


def test_indefinite_system_retries_and_never_nans(cuda_device):
    """One row of the batch cannot be factored: cholesky_ex reports it in
    info (on the card its partial factor holds NaN, on the CPU it is
    finite: the guard reads both), the f64 solve and then the jittered one
    run for that row only, a row that still fails comes out zero, and
    nothing is NaN."""
    from oryx_tpu_torch.ops import als as A
    from oryx_tpu_torch.ops.vector import full_f32, gram

    a = torch.tensor([[1.0, 2.0], [2.0, 1.0]], device=cuda_device)
    _chol, info = torch.linalg.cholesky_ex(a)
    assert int(info) != 0
    x, ok = A.batched_spd_solve_ex(a[None], torch.ones(1, 2, device=cuda_device))
    assert ok.tolist() == [False]

    f, idx, val, mask = _half_step_inputs(n=64, p=16, k=8, m=500, singular_row=5)
    ft = torch.from_numpy(f).cuda()
    calls = []
    real = A.batched_spd_solve_ex

    def spy(a, b):
        calls.append(a.shape[0])
        return real(a, b)

    A.batched_spd_solve_ex = spy
    try:
        with full_f32():
            x = A._half_step(
                ft, gram(ft), *(torch.from_numpy(v).cuda() for v in (idx, val, mask)),
                0.01, 1.0, True, 32, compute_dtype="bfloat16",
            )
    finally:
        A.batched_spd_solve_ex = real
    # two blocks, then the NaN row in f64, then jittered
    assert calls == [32, 32, 1, 1]
    x = x.cpu().numpy()
    assert np.isfinite(x).all()
    assert not x[5].any()
    assert np.abs(x[np.arange(64) != 5]).sum(axis=1).min() > 0


@pytest.mark.parametrize("implicit", [True, False])
def test_fold_in_on_the_card_matches_the_cpu(cuda_device, implicit):
    from oryx_tpu_torch.ops.als import fold_in_batch

    rng = np.random.default_rng(4)
    k, n = 50, 2000
    y = rng.standard_normal((300, k)).astype(np.float32)
    chol = np.linalg.cholesky(y.T @ y + 1e-4 * np.eye(k)).astype(np.float32)
    vals = rng.uniform(-1, 3, n).astype(np.float32)
    xus = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    xus[::7] = 0.0  # new users
    yis = y[rng.integers(0, 300, n)]
    outs = [
        fold_in_batch(*(torch.from_numpy(a).to(dev) for a in (chol, vals, xus, yis)),
                      implicit=implicit).cpu().numpy()
        for dev in ("cpu", cuda_device)
    ]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)


def test_train_als_on_the_card_matches_the_cpu(cuda_device):
    from oryx_tpu_torch.ops.als import aggregate_interactions, train_als

    rng = np.random.default_rng(5)
    u = rng.integers(0, 300, 5000)
    i = rng.integers(0, 200, 5000)
    data = aggregate_interactions(u, i, rng.integers(1, 5, 5000).astype(float))
    y0 = (rng.standard_normal((data.n_items, 8)) * 0.1 + 0.35).astype(np.float32)
    kw = dict(features=8, lam=0.01, iterations=3, resume_y=y0)
    cpu = train_als(data, device="cpu", **kw)
    card = train_als(data, device="cuda", **kw)
    for a, b in ((card.x, cpu.x), (card.y, cpu.y)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_wedge_probe_and_dispatch_records_on_the_card(cuda_device, dtype,
                                                      monkeypatch):
    """The batcher on a card view: a wedged first dispatch fails with
    DeviceWedged, the probe (a one-row dispatch waited on by a CUDA event)
    brings the card back, and each resolved group records a dispatch with
    the peak of the view's type (int8 for a quantized view)."""
    import threading
    import time

    from oryx_tpu_torch.common.perfstats import get_perfstats
    from oryx_tpu_torch.ops.flops import peak_flops_for_name
    from oryx_tpu_torch.ops.transfer import QuantizedMatrix
    from oryx_tpu_torch.serving import batcher as B

    xs, y, scales = _inputs(dtype, cuda_device, n=20000, f=50, b=1)
    if dtype == torch.int8:
        y = QuantizedMatrix(y, scales)
    real = B.topk_dot_batch
    release, calls = threading.Event(), []

    def wedge_first(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            release.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(B, "topk_dot_batch", wedge_first)
    b = B.TopKBatcher(device_timeout=0.5, probe_interval=0.1)
    vec = np.random.default_rng(1).standard_normal(50).astype(np.float32)
    try:
        with pytest.raises(B.DeviceWedged):
            b.submit(vec, 10, y)
        release.set()
        deadline = time.monotonic() + 30
        while b._device_down.is_set() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not b._device_down.is_set()
        t_mark = time.monotonic()
        _vals, idx = b.submit(vec, 10, y, score_mode="exact")
        assert len(idx) == 10
    finally:
        release.set()
        b.close()
    rec = [r for r in get_perfstats().records_since(t_mark)
           if r.kind == "serving"][-1]
    assert rec.occupancy == 1.0 and rec.flops == 2.0 * 20000 * 50
    want = peak_flops_for_name(torch.cuda.get_device_name(0),
                               "int8" if dtype == torch.int8 else "bfloat16")
    assert get_perfstats().peak_for("serving") == want


# ---------------------------------------------------------------------------
# k-means and RDF ops on the card against the same functions on the CPU
# ---------------------------------------------------------------------------

def _kmeans_points(n=20000, d=20, k=16, seed=1):
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((k, d)) * 5).astype(np.float32)
    pts = (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return pts, centers


def test_kmeans_assignment_on_the_card_matches_the_cpu(cuda_device):
    """ids equal (TF32 off on the card), squared distances within 1e-5
    relative to |x|^2 + |c|^2."""
    from oryx_tpu_torch.ops.kmeans import assign_clusters

    pts, centers = _kmeans_points()
    centers = centers + 0.3
    ic, dc = assign_clusters(pts, centers, device="cpu")
    ig, dg = assign_clusters(pts, centers, device=cuda_device)
    np.testing.assert_array_equal(ig.cpu().numpy(), ic.numpy())
    scale = (pts * pts).sum(1) + (centers * centers).sum(1).max()
    err = np.abs(dg.cpu().numpy().astype(np.float64) ** 2 - dc.numpy().astype(np.float64) ** 2)
    assert (err <= 1e-5 * scale).all()


def test_lloyd_on_the_card_matches_the_cpu(cuda_device):
    """Same centers0 and weights (zero weights, an empty cluster): centers
    within 1e-5 of the largest entry (atomic sums in another order),
    counts equal."""
    from oryx_tpu_torch.ops.kmeans import lloyd

    pts, centers = _kmeans_points()
    c0 = pts[:17].copy()
    c0[16] = 1e3
    w = np.ones(len(pts), np.float32)
    w[::5] = 0.0
    cc, nc = lloyd(pts, w, c0, iterations=6, device="cpu")
    cg, ng = lloyd(pts, w, c0, iterations=6, device=cuda_device)
    np.testing.assert_allclose(cg.cpu().numpy(), cc.numpy(), rtol=0,
                               atol=1e-5 * np.abs(cc.numpy()).max())
    np.testing.assert_array_equal(ng.cpu().numpy(), nc.numpy())


def test_train_kmeans_on_the_card(cuda_device):
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.ops.kmeans import sum_squared_error, train_kmeans

    pts, centers = _kmeans_points(k=8)
    RandomManager.use_test_seed()
    timings: dict = {}
    m = train_kmeans(pts, 8, iterations=10, device=cuda_device, timings=timings)
    sse = sum_squared_error(pts, m.centers, device=cuda_device)
    assert sse <= 1.05 * sum_squared_error(pts, centers, device=cuda_device)
    assert m.counts.sum() == len(pts) and timings["lloyd_s"] > 0


def _rdf_inputs(n=20000, p=12, c=5, seed=3):
    from oryx_tpu_torch.ops.rdf import bin_dataset

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p))
    x[:, -1] = rng.integers(0, 6, n)
    y = ((x[:, 0] > 0) * 2 + (x[:, 3] > 0.5) + (x[:, -1] > 3)) % c
    y = np.where(rng.random(n) < 0.1, rng.integers(0, c, n), y).astype(np.int32)
    is_cat = np.zeros(p, bool)
    is_cat[-1] = True
    counts = np.zeros(p, int)
    counts[-1] = 6
    return bin_dataset(x, is_cat, counts, 32), y


def test_grow_forest_on_the_card_matches_the_cpu(cuda_device):
    """Classification with every feature at every node: integer histogram
    sums are exact in any order, so the card's trees equal the CPU's."""
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.ops.rdf import grow_forest

    data, y = _rdf_inputs()
    out = []
    for dev in ("cpu", cuda_device):
        RandomManager.use_test_seed()
        out.append(grow_forest(data, y, num_trees=4, max_depth=7, impurity="entropy",
                               n_classes=5, feature_subset="all", device=dev))
    np.testing.assert_array_equal(out[1].feature, out[0].feature)
    np.testing.assert_array_equal(out[1].split_left, out[0].split_left)
    np.testing.assert_array_equal(out[1].class_counts, out[0].class_counts)


def test_route_binned_device_on_the_card_matches_the_host(cuda_device):
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.ops.rdf import grow_forest, route_binned, route_binned_device

    data, y = _rdf_inputs()
    RandomManager.use_test_seed()
    f = grow_forest(data, y, num_trees=6, max_depth=8, impurity="gini", n_classes=5,
                    feature_subset="sqrt", device=cuda_device)
    leaves = route_binned_device(
        torch.from_numpy(f.feature).to(cuda_device),
        torch.from_numpy(f.split_left).to(cuda_device),
        torch.from_numpy(data.binned).to(cuda_device), f.max_depth)
    np.testing.assert_array_equal(
        leaves.cpu().numpy(), route_binned(f.feature, f.split_left, data.binned, f.max_depth))


def _tied_queries(n_items, n_queries, k, features=50, seed=23) -> int:
    """Queries of the recall gate's corpus whose exact k-th and (k+1)-th
    scores lie within f32 accumulation error of each other: where two
    exact references summed in another order may rank differently."""
    from oryx_tpu_torch.ml.quality import recall_corpus

    y, xs = recall_corpus(n_items, features, n_queries, seed)
    s = np.sort(xs.astype(np.float64) @ y.T.astype(np.float64), axis=1)
    scale = np.abs(xs).max(axis=1) * np.abs(y).max() * features
    return int(np.sum(s[:, -k] - s[:, -k - 1]
                      <= T.f32_tolerance(features) * scale))


def test_recall_gate_on_the_card(cuda_device):
    """The score-mode recall gate on the card: the quantized row runs the
    int8 kernels (launch counts), both rows hold the 0.95 floor, and both
    equal the plain run on the CPU on the same corpus up to one
    1/(k * n_queries) for each query with an f32 tie at its k-th place."""
    from oryx_tpu_torch.ml.quality import (
        MIN_SCORE_MODE_RECALL,
        evaluate_score_mode_recall,
    )

    n_items, n_queries, k = 100_000, 256, 10
    T.reset_launches()
    card = evaluate_score_mode_recall(n_items=n_items, n_queries=n_queries)
    torch.cuda.synchronize()
    assert T.PARTIAL_LAUNCHES_BY_TYPE["int8"] >= 1
    assert T.LAUNCHES["topk_merge"] >= 1
    cpu = evaluate_score_mode_recall(n_items=n_items, n_queries=n_queries,
                                     device="cpu")
    assert card.recall_quantized >= MIN_SCORE_MODE_RECALL
    assert card.recall_approx >= MIN_SCORE_MODE_RECALL
    allowance = _tied_queries(n_items, n_queries, k) / (k * n_queries)
    assert abs(card.recall_quantized - cpu.recall_quantized) <= allowance
    assert abs(card.recall_approx - cpu.recall_approx) <= allowance


def test_shadow_sample_of_a_quantized_card_answer(cuda_device, monkeypatch):
    """A quantized answer from the card, offered to the live quality
    sampler, is rescored exactly on the host: one sample, recall@10 of
    the re-ranked answer against the exact f32 top-10."""
    import oryx_tpu_torch.common.qualitystats as qmod
    from oryx_tpu_torch.apps.als.serving import ALSServingModel
    from oryx_tpu_torch.apps.als.state import state_from_arrays
    from oryx_tpu_torch.common.config import load_config

    qs = qmod.QualityStats()
    qs.configure(load_config(overlay={
        "oryx.monitoring.quality.sample-rate": 1.0}))
    monkeypatch.setattr(qmod, "_default", qs)
    rng = np.random.default_rng(5)
    y = rng.standard_normal((20000, 50)).astype(np.float32)
    state = state_from_arrays(50, True, [], np.zeros((0, 50), np.float32),
                              [f"i{j}" for j in range(20000)], y)
    model = ALSServingModel(state, score_mode="quantized")
    try:
        xu = rng.standard_normal(50).astype(np.float32)
        T.reset_launches()
        pairs = model.top_n(xu, 10)
        assert T.PARTIAL_LAUNCHES_BY_TYPE["int8"] == 1
        assert qs.flush(30)
        assert qs.samples_processed() == 1
        want = {f"i{j}" for j in np.argsort(-(y @ xu))[:10]}
        recall = len(want & {i for i, _ in pairs}) / 10
        assert qs.live_recall("quantized") == pytest.approx(recall)
        assert recall >= 0.9
    finally:
        model.close()
        qs.close()


def _seq_weights(v=2000, d=32, n=256, window=8, seed=7):
    """numpy E, GRU params and left-padded examples (contexts, mask, targets)."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(d)
    e = (rng.standard_normal((v, d)) * s).astype(np.float32)
    params = {"Wx": (rng.standard_normal((d, 3 * d)) * s).astype(np.float32),
              "Wh": (rng.standard_normal((d, 3 * d)) * s).astype(np.float32),
              "b": (rng.standard_normal(3 * d) * 0.1).astype(np.float32)}
    ctx = rng.integers(0, v, (n, window)).astype(np.int32)
    lens = rng.integers(1, window + 1, n)
    mask = (np.arange(window)[None, :] >= window - lens[:, None]).astype(np.float32)
    tgt = rng.integers(0, v, n).astype(np.int32)
    return e, params, np.where(mask > 0, ctx, 0).astype(np.int32), mask, tgt


@pytest.mark.parametrize("accum0", [0.0, 1.0])
def test_seq_adagrad_step_on_the_card_matches_the_cpu(cuda_device, accum0):
    """One autograd + Adagrad step of the next-item GRU from the same
    weights on the card and on the CPU: weights and accumulators within
    1e-4 (the embedding gather's backward sums in another order on the
    card)."""
    from oryx_tpu_torch.ops.seq import _adagrad_step, gru_from_numpy

    e, params, ctx, mask, tgt = _seq_weights()
    out = {}
    for dev in ("cpu", cuda_device):
        w = gru_from_numpy(e, params, dev)
        a = {k: torch.full_like(v, accum0) for k, v in w.items()}
        w, a, loss = _adagrad_step(
            w, a, torch.from_numpy(ctx).long().to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(tgt).long().to(dev), 0.5)
        out[str(dev)] = ({k: v.cpu() for k, v in w.items()},
                         {k: v.cpu() for k, v in a.items()}, float(loss))
    (wc, ac, lc), (wg, ag, lg) = out["cpu"], out["cuda"]
    assert abs(lc - lg) <= 1e-5
    for k in wc:
        torch.testing.assert_close(wg[k], wc[k], atol=1e-4, rtol=0)
        torch.testing.assert_close(ag[k], ac[k], atol=1e-4, rtol=0)


def test_train_gru_on_the_card_matches_the_cpu(cuda_device):
    """From one shared warm start (same weights, same shuffle seed), two
    epochs of minibatches on the card and on the CPU: E and the GRU
    weights within 1e-3."""
    from oryx_tpu_torch.ops.seq import train_gru

    e, params, ctx, mask, tgt = _seq_weights(n=3000)
    got = {}
    for dev in ("cpu", "cuda"):
        got[dev], ran = train_gru(
            ctx, mask, tgt, n_items=len(e), dim=e.shape[1],
            item_ids=[str(j) for j in range(len(e))], epochs=2, batch=512,
            seed_key=torch.Generator().manual_seed(3), resume_e=e,
            resume_params=params, device=dev)
        assert ran == 2
    np.testing.assert_allclose(got["cuda"].e, got["cpu"].e, atol=1e-3, rtol=0)
    for k in params:
        np.testing.assert_allclose(got["cuda"].params[k], got["cpu"].params[k],
                                   atol=1e-3, rtol=0)


def test_seq_serving_on_the_card_answers_like_the_plain_path(cuda_device):
    """The seq serving model on the card (bf16 view, the hand-written
    partial + merge kernels through the batcher) against the same model on
    the CPU (the plain versions): the same ids but near ties, values within
    1e-5 (both re-rank exactly on the host), and each request launched
    the bf16 partial kernel and the merge."""
    from oryx_tpu_torch.apps.seq.serving import SeqServingModelManager
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.common.config import load_config

    e, params, ctx, mask, _ = _seq_weights(v=50000)
    art = ModelArtifact("seq", extensions={"dim": "32", "window": "8"},
                        tensors={"E": e, **params})
    ids = [f"i{j}" for j in range(len(e))]
    art.set_extension("ItemIDs", ids)
    managers = {}
    for dev in ("cpu", "cuda"):
        managers[dev] = SeqServingModelManager(load_config(), device=dev)
        managers[dev].consume_key_message("MODEL", art.to_string())
    T.reset_launches()
    for r in range(32):
        items = [ids[int(j)] for j in ctx[r][mask[r] > 0]]
        want = managers["cpu"].get_model().next_items(items, 10, exclude=set(items))
        got = managers["cuda"].get_model().next_items(items, 10, exclude=set(items))
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   atol=1e-5, rtol=0)
        for (a, va), (b, vb) in zip(want, got):
            assert a == b or abs(va - vb) <= 1e-5
    assert T.PARTIAL_LAUNCHES_BY_TYPE["bfloat16"] >= 32
    assert T.LAUNCHES["topk_merge"] >= 32


# ---- sharded views: the cross-shard merge --------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shards,n,b,k", [
    (2, 20000, 37, 10), (4, 20000, 512, 32), (3, 7, 3, 7), (4, 50000, 1, 128),
])
def test_sharded_dispatch_matches_unsharded(cuda_device, quantize, shards, n,
                                            b, k):
    """A sharded view's dispatch (a partial launch per shard, one merge
    across them) gives the unsharded view's answers bit for bit, in bf16
    and int8; the cross-shard merge equals its plain version."""
    from oryx_tpu_torch.ops.als import topk_dot_batch
    from oryx_tpu_torch.ops.shard_topk import _shard_partials
    from oryx_tpu_torch.ops.transfer import (
        quantized_device_put, sharded_device_put, staged_device_put,
    )

    rng = np.random.default_rng(shards * 1000 + n)
    y = rng.standard_normal((n, 50)).astype(np.float32)
    xs = torch.from_numpy(rng.standard_normal((b, 50)).astype(np.float32)).to(cuda_device)
    sm = sharded_device_put(y, shards, dtype=None if quantize else torch.bfloat16,
                            quantize=quantize)
    full = (quantized_device_put(y) if quantize
            else staged_device_put(y, dtype=torch.bfloat16))
    T.reset_launches()
    v1, i1 = topk_dot_batch(xs, sm, k=k)
    torch.cuda.synchronize()
    live = sum(1 for s in sm.shards if s.shape[0])
    assert T.LAUNCHES == {"topk_dot_partial": live, "topk_merge": 1}
    v0, i0 = topk_dot_batch(xs, full, k=k)
    assert torch.equal(v0, v1) and torch.equal(i0, i1)
    xq = T.quantize_queries(xs)[0] if quantize else xs.to(torch.bfloat16)
    kb = T._next_pow2(k)
    parts = [_shard_partials(xq, s, sm.plan.lo(j), kb)
             for j, s in enumerate(sm.shards) if s.shape[0]]
    pv = torch.cat([p[0] for p in parts])
    pi = torch.cat([p[1] for p in parts])
    mv, mi = T.topk_merge(pv, pi, k=k)
    rv, ri = T.topk_merge_reference(pv, pi, k=k)
    assert torch.equal(mv, rv) and torch.equal(mi, ri)


def test_merge_of_padded_partials_matches_plain_version(cuda_device):
    """merge_topk_partials pads lists of uneven widths with (-inf,
    INT32_MAX): the kernel merges them as its plain version does."""
    from oryx_tpu_torch.ops.shard_topk import merge_topk_partials

    g = torch.Generator().manual_seed(5)
    parts = []
    for w in (3, 32, 17, 1):
        v, _ = torch.sort(torch.randn(64, w, generator=g), dim=1, descending=True)
        i = torch.randperm(100000, generator=g)[: 64 * w].view(64, w).int()
        parts.append((v.to(cuda_device), i.to(cuda_device)))
    T.reset_launches()
    v, i = merge_topk_partials(parts, k=20)
    assert T.LAUNCHES["topk_merge"] == 1
    cpu = [(a.cpu(), b.cpu()) for a, b in parts]
    rv, ri = merge_topk_partials(cpu, k=20)
    assert torch.equal(v.cpu(), rv) and torch.equal(i.cpu(), ri)


def test_cross_shard_merge_wider_than_the_kernel_raises(cuda_device):
    """On the card every cross-shard merge is the kernel: a padded width
    over its 128 slots raises as ``topk_merge`` does, and is never served
    by the plain merge."""
    from oryx_tpu_torch.ops.shard_topk import merge_topk_partials

    g = torch.Generator().manual_seed(9)
    parts = []
    for w in (129, 40):
        v, _ = torch.sort(torch.randn(8, w, generator=g), dim=1, descending=True)
        i = torch.randperm(10000, generator=g)[: 8 * w].view(8, w).int()
        parts.append((v.to(cuda_device), i.to(cuda_device)))
    T.reset_launches()
    with pytest.raises(ValueError, match="kb"):
        merge_topk_partials(parts, k=20)
    with pytest.raises(ValueError, match="kb"):
        merge_topk_partials(parts[1:], k=200)
    assert T.LAUNCHES["topk_merge"] == 0


@pytest.mark.parametrize("quantize", [False, True])
def test_sharded_dispatch_past_the_kernel_k_matches_unsharded(cuda_device,
                                                              quantize):
    """k > 128 takes no kernel on either view: the sharded view's library
    top-k per shard and stable sort of their union launch no merge and
    answer as the unsharded view's library route does. int8 sums are exact
    integers, so there the answers are bit-identical; a bf16 f32 product
    may round differently at another item count in the library, so there
    both answers are held to the float64 top-k within ``f32_tolerance``."""
    from oryx_tpu_torch.ops.als import topk_dot_batch
    from oryx_tpu_torch.ops.transfer import (
        quantized_device_put, sharded_device_put, staged_device_put,
    )

    rng = np.random.default_rng(17)
    y = rng.standard_normal((20000, 50)).astype(np.float32)
    xs = torch.from_numpy(rng.standard_normal((33, 50)).astype(np.float32)).to(cuda_device)
    sm = sharded_device_put(y, 4, dtype=None if quantize else torch.bfloat16,
                            quantize=quantize)
    full = (quantized_device_put(y) if quantize
            else staged_device_put(y, dtype=torch.bfloat16))
    T.reset_launches()
    v1, i1 = topk_dot_batch(xs, sm, k=200)
    assert T.LAUNCHES["topk_merge"] == 0
    v0, i0 = topk_dot_batch(xs, full, k=200)
    if quantize:
        assert torch.equal(v0, v1) and torch.equal(i0, i1)
        return
    exact = (xs.to(torch.bfloat16).double().cpu()
             @ torch.from_numpy(y).to(torch.bfloat16).double().T)
    best = torch.sort(exact, dim=1, descending=True).values[:, :200]
    tol = T.f32_tolerance(50)
    for v, i in ((v0, i0), (v1, i1)):
        got = exact.gather(1, i.cpu().long())
        assert (got - v.cpu().double()).abs().max() <= tol
        assert (got - best).abs().max() <= tol


def test_concurrent_als_and_rdf_builds_on_the_card(cuda_device):
    """BASELINE.json configs[4] on the card (tests/test_multitenant.py's
    contract): an ALS build and a forest built from two threads at once on
    one card both come out right (AUC above 0.70, no NaN rows, accuracy
    above 0.85)."""
    import threading

    from oryx_tpu_torch.ml.quality import build_and_evaluate
    from oryx_tpu_torch.ops.rdf import bin_dataset, grow_forest, predict_class_probs

    results, errors = {}, []

    def als_tenant():
        try:
            results["als"] = build_and_evaluate(
                n_users=1500, n_items=900, nnz=80_000, features=16,
                iterations=4, compute_dtype="bfloat16", seed=5,
                sample_users=300, device=cuda_device)
        except Exception as e:  # noqa: BLE001
            errors.append(("als", e))

    def rdf_tenant():
        try:
            rng = np.random.default_rng(13)
            x = rng.standard_normal((20_000, 12)).astype(np.float32)
            y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
            binned = bin_dataset(x, np.zeros(12, dtype=bool),
                                 np.zeros(12, dtype=np.int32), 16)
            forest = grow_forest(binned, y, num_trees=6, max_depth=6,
                                 impurity="entropy", n_classes=2,
                                 device=cuda_device)
            pred = predict_class_probs(forest, binned.binned)
            results["rdf_acc"] = float((pred.argmax(-1) == y).mean())
        except Exception as e:  # noqa: BLE001
            errors.append(("rdf", e))

    threads = [threading.Thread(target=als_tenant),
               threading.Thread(target=rdf_tenant)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert results["als"].nan_rows == 0
    assert results["als"].auc > 0.70
    assert results["rdf_acc"] > 0.85
