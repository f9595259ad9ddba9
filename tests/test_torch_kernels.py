"""The port's kernels on the CPU (their plain PyTorch versions) against
repro.kernels.ref and the Pallas kernels in interpret mode; the CUDA
kernels themselves are held against the same plain versions on the card
by chip_smoke.py. Also the qmm kernel's launch plan, a pure function, at
every shape chip_smoke.py gives the kernel, and the paged-attention and
per-channel fake-quant launch plans walked with their kernels' own index
arithmetic."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import qtensor as jq
from repro.kernels import ref as jref
from repro.kernels.ef_sqnorm import ef_sqnorm_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.qmm import qmm_pallas
from repro_torch import qtensor as tq
from repro_torch.kernels import ef_sqnorm as kef, ops, qmm as kqmm, ref as tref
from repro_torch.kernels import fake_quant as kfq, paged_attention as kpa
from _torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_ef_sqnorm(dtype):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(4, 3000)).astype(np.float32)
    gj = jnp.asarray(g, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32)))
    if dtype == "bfloat16":
        gt = gt.to(torch.bfloat16)
    got = ops.ef_sqnorm(gt).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.ef_sqnorm(gj)), rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ef_sqnorm_pallas(gj, interpret=True)),
                               rtol=1e-5)
    assert got.dtype == np.float32


@pytest.mark.parametrize("bits", (8, 6, 4, 3))
@pytest.mark.parametrize("group_size", [None, 16])
def test_qmm(bits, group_size):
    rng = np.random.default_rng(bits)
    k, n, m = 64, 48, 3
    w = rng.normal(size=(k, n)).astype(np.float32)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    xs = (rng.random((m, 1)) * 0.1 + 0.01).astype(np.float32)
    wj = jq.quantize(jnp.asarray(w), bits, group_size=group_size)
    wt = tq.quantize(torch.from_numpy(w), bits, group_size=group_size)
    # exact int32 group products
    np.testing.assert_array_equal(
        tref.qmm_group_products(torch.from_numpy(xq), wt).numpy(),
        np.asarray(jref.qmm_group_products(jnp.asarray(xq), wj)))
    y, terms = kqmm.qmm(torch.from_numpy(xq), wt, torch.from_numpy(xs),
                        return_terms=True)
    g = wt.scale.shape[0]
    want_dots = np.einsum("mgk,gkn->gmn", xq.astype(np.int64).reshape(m, g, -1),
                          np.asarray(wj.unpack()).astype(np.int64).reshape(g, -1, n))
    # the folded terms: exact dots, one fp32 rounding of the scale product
    np.testing.assert_array_equal(
        terms.numpy(),
        want_dots.astype(np.float32) * wt.scale.reshape(g, 1, n).numpy())
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.qmm(jnp.asarray(xq), wj,
                                                              jnp.asarray(xs))),
                               rtol=1e-5, atol=1e-6)
    yp = qmm_pallas(jnp.asarray(xq), wj.data, jnp.asarray(xs),
                    wj.scale.reshape(-1, n), bits=bits, k=k, interpret=True)
    # the Pallas kernel folds groups one by one, the oracle sums them: the
    # fold order differs, so cancellation is covered by 1e-5 * max|y|
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), rtol=1e-5,
                               atol=1e-5 * float(np.abs(yp).max()))
    np.testing.assert_allclose(
        ops.qmm(torch.from_numpy(xq), wt, torch.from_numpy(xs)).numpy(),
        y.numpy(), rtol=0, atol=0)


def test_int8_products_do_not_wrap():
    # torch's CPU int8 @ int8 wraps; the plain qmm must widen first
    xq = torch.full((1, 128), 127, dtype=torch.int8)
    wt = tq.quantize(torch.ones((128, 2)), 8)
    d = tref.qmm_group_dots(xq, wt)
    assert int(d[0, 0, 0]) == 127 * 127 * 128


def test_qmm_validation():
    wt = tq.quantize(torch.ones((64, 8)), 8)
    with pytest.raises(ValueError):
        ops.qmm(torch.zeros((2, 32), dtype=torch.int8), wt, torch.ones(2))
    big = tq.quantize(torch.ones((140000, 1)), 8)     # group dot can wrap
    with pytest.raises(ValueError, match="overflow int32"):
        ops.qmm(torch.zeros((1, 140000), dtype=torch.int8), big, torch.ones(1))


def _chip_smoke_shapes(kernel):
    """(M, K, N, group size) of every launch chip_smoke.py's phase 2 gives
    ``kernel`` ("qmm" or "qmm_groups"), with the tp=2 and tp=4 shards of
    the qmm_groups shapes."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if kernel == "qmm":
        return [(m, k, n, 128) for name, _, kw in cs.PHASE2 if name == "qmm"
                for _, k, n in kw.get("shapes", cs.QMM_SHAPES)
                for m in kw.get("ms", (1, 4))]
    shapes = []
    for name, k, n, _, m, gs in cs.QMM_GROUPS_SHAPES:
        shapes.append((m, k, n, gs))
        if "shard" not in name:
            shapes += [(m, k // 2, n, gs), (m, k // 4, n, gs)]
    return shapes


@pytest.mark.parametrize("kernel", ["qmm", "qmm_groups"])
def test_qmm_launch_plan_covers_the_chip_shapes(kernel):
    """Every shape the card's checks give qmm/qmm_groups, the tp=2/4
    shards included: the grid covers N and M, the warps stay within the
    kernel's limit, the shared memory within the card's, a pass holds up
    to 64 groups (zamba2's and llama3_8b's w_down, G=112, fold in two),
    the small projections run 16 warps a CTA, and only the heads' N
    (internlm2, llama3, minitron; not phi3's 32,064) gives a lane 16
    columns."""
    passes = set()
    for m, k, n, gs in _chip_smoke_shapes(kernel):
        groups = k // gs
        plan = kqmm.launch_plan(m, k, n, groups)
        assert plan.quads == (4 if n in (92544, 128256, 256000) else 1)
        assert plan.col_tiles == -(-n // (32 * plan.quads))
        assert plan.m_tiles * kqmm.TILE_ROWS >= m
        assert 1 <= plan.warps <= kqmm.MAX_WARPS
        assert plan.steps_per_group == 4
        assert plan.smem <= kqmm.MAX_SMEM
        assert plan.pass_groups == min(groups, kqmm.MAX_PASS_GROUPS)
        passes.add(-(-groups // plan.pass_groups))
        if plan.col_tiles <= kqmm.SMS:
            assert plan.warps == min(kqmm.MAX_WARPS, groups * 4)
    assert passes == {1, 2}


def test_qmm_launch_plan_spans_every_group():
    """A group of any size at any offset from a 4-k unit (a W8 group need
    not be a multiple of 4) fits in the plan's k32 steps; any number of
    groups runs in passes that fit in shared memory, with 16-column lanes
    (a head-wide N) at M = 8 too."""
    for gs in range(1, 300):
        spg = kqmm.launch_plan(1, 4 * gs, 64, 4).steps_per_group
        for g in range(4):
            span = (-(-(g + 1) * gs // 4)) - (g * gs // 4)
            assert span <= 8 * spg, (gs, g)
    plan = kqmm.launch_plan(8, 2**20, 256, 2**13)
    assert plan.pass_groups == kqmm.MAX_PASS_GROUPS
    assert plan.smem <= kqmm.MAX_SMEM
    plan = kqmm.launch_plan(8, 8192, 92544, 64)
    assert plan.quads == 4 and 1 <= plan.pass_groups < 64
    assert plan.smem <= kqmm.MAX_SMEM


def _pages(rng, bits, p, page, kvh, dh):
    if bits >= 16:
        k = rng.normal(size=(p, page, kvh, dh)).astype(np.float32)
        v = rng.normal(size=(p, page, kvh, dh)).astype(np.float32)
        return k, v, None, None
    qm = int(jq.qmax_for_bits(bits))
    qk = rng.integers(-qm, qm + 1, size=(p, page, kvh, dh)).astype(np.int8)
    qv = rng.integers(-qm, qm + 1, size=(p, page, kvh, dh)).astype(np.int8)
    k = np.asarray(jq.pack(jnp.asarray(qk), bits, axis=-1))
    v = np.asarray(jq.pack(jnp.asarray(qv), bits, axis=-1))
    ks = (rng.random((p, kvh)) * 0.1 + 0.01).astype(np.float32)
    vs = (rng.random((p, kvh)) * 0.1 + 0.01).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("bits", (16, 8, 6, 4, 3))
def test_paged_attention(bits):
    rng = np.random.default_rng(bits)
    b, kvh, g, dh, page, np_ = 3, 2, 2, 16, 4, 5
    p = 16
    k, v, ks, vs = _pages(rng, bits, p, page, kvh, dh)
    q = rng.normal(size=(b, 1, kvh * g, dh)).astype(np.float32)
    table = rng.permutation(p)[:b * np_].reshape(b, np_).astype(np.int32)
    table[0, 2:] = p            # unmapped tail
    table[1, 4] = p + 7         # out-of-range id, clipped then masked
    pos = np.array([5, 13, 19], np.int32)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (q, k, v, table, pos, ks, vs)]
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (q, k, v, table, pos, ks, vs)]
    want = np.asarray(jref.paged_attention(*jargs, bits=bits))
    got = ops.paged_attention(*targs, bits=bits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    by_len = kpa.paged_attention(targs[0].reshape(b, kvh, g, dh), *targs[1:4],
                                 targs[4] + 1, targs[5], targs[6], bits=bits)
    assert torch.equal(by_len, got)
    pal = paged_attention_pallas(jargs[0].reshape(b, kvh, g, dh), *jargs[1:4],
                                 jargs[4] + 1, jargs[5], jargs[6], bits=bits,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=1e-5, rtol=0)


# (NP, page, Dh, G): phase 2's shapes on the card (internlm2's GQA and
# olmoe's, max_len 256), its long-context row (NP = 256), the dense cache
# read as pages at a smoke config, a 64K context, and head dims that take the kernel's
# checked loads (12), padded lanes (96) and two chunk passes (576); the
# rest of the dense family: llama3_8b's G = 4, minitron_4b's G = 3 (an odd
# G: the kernel's last pass over the query rows holds one), phi3_mini's
# Dh = 96 at G = 1, and the minitron smoke config's G = 3 at Dh = 16
PAGED_PLAN_SHAPES = [(16, 16, 128, 2), (16, 16, 128, 1), (256, 16, 128, 2),
                     (4096, 16, 128, 1),
                     (4, 8, 12, 1), (8, 8, 16, 2), (32, 16, 96, 4),
                     (40, 16, 576, 2),
                     (16, 16, 128, 4), (16, 16, 128, 3), (16, 16, 96, 1),
                     (4, 8, 16, 3)]


def _paged_walk(plan, np_, page, length):
    """The pages that ``paged_attn_kernel`` visits for one (slot, head)
    of ``length`` tokens, with its own index arithmetic: the valid pages
    npv, the CTAs that hold some (nvc), the CTAs that run past the early
    exit, and for each page the (CTA, warp) that scores it. Also checks
    that no warp reads a table entry past NP."""
    npv = 0 if length <= 0 else min(-(-length // page), np_)
    ppc = plan.warps * plan.pages_per_warp
    nvc = -(-npv // ppc)
    running, owners = [], {}
    for split in range(plan.ctas):
        if split >= max(nvc, 1):
            continue
        running.append(split)
        for warp in range(plan.warps):
            pw0 = split * ppc + warp * plan.pages_per_warp
            assert pw0 + max(0, min(plan.pages_per_warp, np_ - pw0)) <= np_
            npw = max(0, min(plan.pages_per_warp, npv - pw0))
            for j in range(npw):
                owners.setdefault(pw0 + j, []).append((split, warp))
    return npv, nvc, running, owners


@pytest.mark.parametrize("np_,page,dh,g", PAGED_PLAN_SHAPES)
def test_paged_attention_launch_plan_owns_every_page_once(np_, page, dh, g):
    """The kernel's split of a (slot, kv-head)'s pages, walked with the
    kernel's own arithmetic for lengths across the context: every valid
    page scored by exactly one (CTA, warp), in page order, so the folds
    run in page order; the CTAs that exit at once are exactly those past
    the last valid page (none but CTA 0 for an empty slot), and a split
    never indexes past the partials the wrapper allocates for B x KV
    (slot, head)s. The plan is a function of (NP, page, Dh, G, KV width)
    alone, so every slot of any batch and every kv-head shard walks the
    same pages the same way. Up to 8 pages are one CTA (no cross-CTA
    fold), and a warp takes one page up to 64."""
    import inspect
    assert list(inspect.signature(kpa.launch_plan).parameters) == [
        "np_", "page", "dh", "g", "kvmode"]
    stride = max(1, np_ // 96)
    lengths = sorted({0, 1, np_ * page, np_ * page + 7}
                     | {j * page + d for j in range(0, np_, stride)
                        for d in (1, page // 2, page)})
    for kvmode in (32, 16, 8, 6, 4):
        plan = kpa.launch_plan(np_, page, dh, g, kvmode)
        for length in lengths:
            npv, nvc, running, owners = _paged_walk(plan, np_, page, length)
            assert sorted(owners) == list(range(npv))
            assert all(len(o) == 1 for o in owners.values())
            order = [owners[j][0] for j in range(npv)]
            assert order == sorted(order)
            assert running == list(range(max(nvc, 1)))
            assert nvc <= plan.ctas
            for b, kvh in ((1, 4), (4, 8), (4, 16)):
                # partial (bh, split) of the last (slot, head) is the
                # wrapper's last block when the context fills every CTA
                last = ((b * kvh - 1) * plan.ctas + max(nvc, 1) - 1)
                assert last < b * kvh * plan.ctas
        assert 1 <= plan.warps * 32 <= 256 and 1 <= plan.pages_per_warp <= 32
        assert plan.ctas == -(-np_ // (plan.warps * plan.pages_per_warp))
        assert plan.ctas <= kpa.MAX_GRID_Y and plan.smem <= kpa.MAX_SMEM
        lanes = 1 << plan.lanes_log2
        assert lanes <= 32 and plan.dpad == plan.chunk_sets * lanes * 16 >= dh
        assert (plan.chunk_sets > 1) == (dh > 512)
        assert plan.pages_per_warp == min(32, -(-np_ // 64))
        if np_ <= 8:
            assert plan.ctas == 1


def _fq_walk(plan, shape, axis, esize):
    """The (element, channel) pairs the per-channel fake-quant kernel of
    ``plan``'s route visits on x of ``shape``, with its own index
    arithmetic (``fq_rows_kernel``'s four-row batches and tail,
    ``fq_runs_kernel``'s incremental channel, ``fq_channel_kernel``'s
    ``Chan`` walk)."""
    axis %= len(shape)
    n, c = int(np.prod(shape)), shape[axis]
    inner = int(np.prod(shape[axis + 1:]))
    v = 16 // esize if plan.vec else 1
    elems, chans = [], []
    if plan.route == kfq.ROUTE_ROWS:
        units, rows = c // v, n // c
        step = plan.blocks_y * plan.ty
        for u in range(plan.blocks_x * plan.tx):
            if u >= units:
                continue
            for r0 in range(step):
                r, seen = r0, []
                while r + 3 * step < rows:
                    seen += [r, r + step, r + 2 * step, r + 3 * step]
                    r += 4 * step
                while r < rows:
                    seen.append(r)
                    r += step
                for r in seen:
                    elems.append(r * c + u * v + np.arange(v))
                    chans.append(u * v + np.arange(v))
    elif plan.route == kfq.ROUTE_RUNS:
        units, runs = inner // v, n // inner
        step = plan.blocks_x * plan.ty
        for ru0 in range(step):
            if ru0 >= runs:
                continue
            ch, ru = ru0 % c, ru0
            while ru < runs:
                for tx in range(plan.tx):
                    for i in range(tx, units, plan.tx):
                        elems.append(ru * inner + i * v + np.arange(v))
                        chans.append(np.full(v, ch))
                ch += step % c
                ch -= c if ch >= c else 0
                ru += step
    else:
        # a grid-stride loop: every vector once, whatever the grid
        head = 0
        if plan.vec:
            nv = n // v
            for i in range(nv):
                q, r = divmod(i * v, inner)
                ch = q % c
                for j in range(v):
                    elems.append(np.array([i * v + j]))
                    chans.append(np.array([ch]))
                    r += 1
                    if r == inner:
                        r, ch = 0, (ch + 1) % c
            head = nv * v
        for i in range(head, n):
            elems.append(np.array([i]))
            chans.append(np.array([(i // inner) % c]))
    return np.concatenate(elems), np.concatenate(chans), n, inner, c


# (shape, axis, dtype, aligned, route): the last axis in 16-byte vectors,
# in one channel a thread (a ragged row, an unaligned pointer); a long
# inner stride (axis 0, a middle axis) in vectors and not; a short one
FQ_PLAN_SHAPES = [
    ((37, 64), -1, torch.bfloat16, True, kfq.ROUTE_ROWS),
    ((9, 1000), -1, torch.float32, True, kfq.ROUTE_ROWS),
    ((300, 257), -1, torch.bfloat16, True, kfq.ROUTE_ROWS),
    ((37, 64), -1, torch.float16, False, kfq.ROUTE_ROWS),
    ((32, 2048), 0, torch.bfloat16, True, kfq.ROUTE_RUNS),
    ((40, 300), 0, torch.bfloat16, True, kfq.ROUTE_RUNS),
    ((3, 96, 512), 1, torch.float32, True, kfq.ROUTE_RUNS),
    ((16, 1024), 0, torch.bfloat16, False, kfq.ROUTE_RUNS),
    ((64, 96, 12), 1, torch.bfloat16, True, kfq.ROUTE_WALK),
    ((7, 9, 3), 1, torch.float32, False, kfq.ROUTE_WALK),
]


@pytest.mark.parametrize("shape,axis,dtype,aligned,route", FQ_PLAN_SHAPES)
def test_fake_quant_launch_plan_visits_every_element_once(shape, axis, dtype,
                                                          aligned, route):
    """``fake_quant.launch_plan``'s route for the last axis, axis 0, a
    middle axis, ragged rows and unaligned pointers, walked with the
    kernel's own index arithmetic: every element of x visited exactly
    once, with its own channel (i // inner) % C; blocks of 256 threads,
    a grid the card takes; 16-byte vectors only where a row or run is a
    whole number of them and both pointers are aligned."""
    esize = torch.empty((), dtype=dtype).element_size()
    plan = kfq.launch_plan(shape, axis, dtype, aligned)
    assert plan.route == route
    assert plan.tx * plan.ty == kfq.THREADS and plan.tx % 32 == 0
    assert 1 <= plan.blocks_y <= kfq.MAX_GRID_Y and plan.blocks_x >= 1
    elems, chans, n, inner, c = _fq_walk(plan, shape, axis, esize)
    assert np.array_equal(np.sort(elems), np.arange(n))
    assert np.array_equal(chans, (elems // inner) % c)
    if not aligned:
        assert not plan.vec


def test_fake_quant_launch_plan_at_the_library_shapes():
    """The plan at phase 3d's weight blocks and phase 2's timed shapes:
    the last axis of every bf16 2048-wide block takes the rows route in
    16-byte vectors (a warp of column vectors to a block of them) and a
    grid of ``ROWS_TARGET_BLOCKS``; axis 0 takes whole runs with
    ``RUN_LOADS`` loads a thread where the run is long enough; the
    (4, 512, 2048) activation both."""
    bf = torch.bfloat16
    p = kfq.launch_plan((2048, 8192), -1, bf)
    assert p == kfq.FqPlan(kfq.ROUTE_ROWS, True, 256, 1, 4, 64)
    p = kfq.launch_plan((92544, 2048), -1, bf)
    assert p == kfq.FqPlan(kfq.ROUTE_ROWS, True, 256, 1, 1,
                           kfq.ROWS_TARGET_BLOCKS)
    p = kfq.launch_plan((2048, 8192), 0, bf)
    assert p == kfq.FqPlan(kfq.ROUTE_RUNS, True, 256, 1, 2048, 1)
    p = kfq.launch_plan((92544, 2048), 0, bf)
    assert p == kfq.FqPlan(kfq.ROUTE_RUNS, True, 64, 4,
                           kfq.RUNS_TARGET_BLOCKS, 1)
    assert kfq.launch_plan((4, 512, 2048), -1, bf).route == kfq.ROUTE_ROWS
    assert kfq.launch_plan((4, 512, 2048), 1, bf).route == kfq.ROUTE_RUNS
    assert kfq.launch_plan((2048, 2048), -1, torch.float32).tx == 256
    assert kfq.launch_plan((2048, 64), -1, bf) == kfq.FqPlan(
        kfq.ROUTE_ROWS, True, 32, 8, 1, 256)
    assert kfq.launch_plan((40, 300), 0, bf).tx == 64


_CTYPE_OF = {"int": "c_int", "long long": "c_longlong", "float": "c_float"}


def test_launcher_signatures_match_the_sources():
    """Every ``extern "C"`` launcher in csrc/ has its ctypes argument types
    in ``_build.SIGNATURES``, one for one: a pointer (and the stream) as
    c_void_p, ``int`` as c_int, ``long long`` as c_longlong, ``float`` as
    c_float. ctypes passes an extra argument to a C function silently, so
    a list one short would hand the stream to the wrong slot."""
    import ctypes
    import re
    from repro_torch.kernels import _build

    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(
                r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            kinds = []
            for param in params.split(","):
                decl = " ".join(param.replace("const", " ").split())
                if "*" in decl:
                    kinds.append("c_void_p")
                else:
                    kinds.append(_CTYPE_OF[decl.rsplit(" ", 1)[0]])
            found[name] = kinds
    assert sorted(found) == sorted(_build.SIGNATURES)
    for name, kinds in found.items():
        assert _build.SIGNATURES[name] == [getattr(ctypes, t) for t in kinds], name


def test_kernels_need_cpu_or_cuda():
    with pytest.raises(ValueError):
        kef.ef_sqnorm(torch.zeros((2, 3), device="meta"))
