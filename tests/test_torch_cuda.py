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
