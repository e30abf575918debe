"""The mesh seeder's two kernels (aligngraph2_tpu_torch/csrc/seed_mesh.cu)
on the CPU: their plain versions (``_seed_block_candidates_ref``,
``_select_read_candidates_ref`` of parallel/sharded.py) and a numpy model
of each kernel's algorithm, written here, against the JAX package's
``_seed_block_candidates`` and ``_select_read_candidates`` on the cases
the kernels must get right:

  * the histogram: a stream with no hit (top-T = bins 0 .. T-1 at count
    0), fewer non-zero bins than T, equal counts (the lower bin first),
    runs longer than max_occ, diagonals below 0 and past the last bin,
    and ``occ`` cutting runs;
  * the dedup: N not a multiple of 32 and above 64, K above the kept
    count, min_hits 0, diagonals near +-2^31 on one target (the int32
    difference wraps), the prune off and on, and a kept list past the
    shared entries (the kernel's spill).

The models follow the kernels step by step: two binary searches and
shared-bin adds per query position, then T rounds of an argmax on the
packed key sm_h * nbins + (nbins - 1 - bin); a walk of the kept list in
the stable count order with lane-owned entries, an exact integer mean,
and a ballot-ranked first K.  Also: the wrappers take the plain versions
on CPU tensors, and the launch functions raise on CPU tensors.  Every
comparison is exact."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligngraph2_tpu.parallel import sharded as jsh
from aligngraph2_tpu_torch.ops import _cuda
from aligngraph2_tpu_torch.parallel import sharded as tsh
from tests.synth import random_genome

torch.set_num_threads(1)

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def i32(x: int) -> int:
    """x wrapped to int32."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


# ---------------------------------------------------------------------------
# seed_block_kernel


def lower_bound(a, start, n, code):
    """The kernel's lower_bound over a[start .. start + n), as an index
    from ``start``."""
    lo = 0
    while n > 0:
        half = n >> 1
        if a[start + lo + half] < code:
            lo += half + 1
            n -= half + 1
        else:
            n = half
    return lo


def seed_model(q_codes, q_valid, sorted_codes, sorted_pos, *, NQ, nbins,
               bin_w, occ, max_occ, top_t):
    """seed_block_kernel's algorithm in numpy: per (stream, block) the
    search table of every 2^SEED_SHIFT-th code, a lower bound search in
    it and then in the block window it leaves, a stop where the code is not at lo, a run-length search over
    at most max_occ + 1 entries, the first min(n, occ) hits into the bins,
    then top_t rounds of an argmax on the packed key with taken bins
    skipped.  Returns cnt, diag (S, NB, T) int32."""
    S, NK = q_codes.shape
    NB, L = sorted_codes.shape
    shift = tsh.SEED_SHIFT
    ns = ((L - 1) >> shift) + 1
    cnt = np.zeros((S, NB, top_t), np.int32)
    diag = np.zeros((S, NB, top_t), np.int32)
    for s in range(S):
        for blk in range(NB):
            sc, sp = sorted_codes[blk], sorted_pos[blk]
            tab = [int(sc[i << shift]) for i in range(ns)]
            hist = [0] * nbins
            dsum = [0] * nbins
            for p in range(NK):
                if not q_valid[s, p]:
                    continue
                code = int(q_codes[s, p])
                i0 = lower_bound(tab, 0, ns, code)
                w0 = ((i0 - 1) << shift) + 1 if i0 else 0
                w1 = min(i0 << shift, L)
                lo = w0 + lower_bound(sc, w0, w1 - w0, code)
                if lo == L or sc[lo] != code:
                    continue
                hi, n_left = lo, min(L - lo, max_occ + 1)
                while n_left > 0:
                    half = n_left >> 1
                    if sc[hi + half] <= code:
                        hi += half + 1
                        n_left -= half + 1
                    else:
                        n_left = half
                n = hi - lo
                if n == 0 or n > max_occ:
                    continue
                for o in range(min(n, occ)):
                    d = i32(int(sp[min(lo + o, L - 1)]) - p + NQ)
                    x = min(max(d // bin_w, 0), nbins - 1)
                    hist[x] = i32(hist[x] + 1)
                    dsum[x] = i32(dsum[x] + d)
            taken = set()
            for t in range(top_t):
                best = None
                for x in range(nbins):
                    if x in taken:
                        continue
                    h = i32(hist[x] + (hist[x + 1] if x + 1 < nbins else 0))
                    key = h * nbins + (nbins - 1 - x)
                    best = key if best is None else max(best, key)
                x = nbins - 1 - best % nbins   # Python's % is a floor mod
                h = i32(hist[x] + (hist[x + 1] if x + 1 < nbins else 0))
                d = i32(dsum[x] + (dsum[x + 1] if x + 1 < nbins else 0))
                cnt[s, blk, t] = h
                diag[s, blk, t] = i32(d // h - NQ) if h > 0 else 0
                taken.add(x)
    return cnt, diag


def _index_of(genome, k, BL):
    from aligngraph2_tpu.io.seqdb import SeqDatabase as JDB
    idx = jsh.build_block_index(JDB([("g", genome)]), k, BL)
    return idx.sorted_codes, idx.sorted_pos


def _encode(reads, NQ):
    from aligngraph2_tpu_torch.io.seqdb import encode_seq
    q = np.zeros((len(reads), NQ), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = encode_seq(r) if r else np.zeros(0, np.uint8)
        q[i, :len(c)] = c
        lens[i] = len(c)
    return q, lens


def _codes(q, lens, k):
    from aligngraph2_tpu_torch.ops.kmer import kmer_codes_batch
    qc, qv = kmer_codes_batch(torch.from_numpy(q), torch.from_numpy(lens), k)
    return qc.numpy(), qv.numpy()


def _genome_case():
    """A genome with one 150 bp segment at three offsets (equal counts at
    three diagonals) and a 120 bp run of A (code 0 occurs ~110 times).
    Streams: the segment (ties), a unique 60 bp piece (one or two
    non-zero bins, fewer than T), a read of the A run, a random read, a
    read shorter than k and an empty row (no hit at all)."""
    rng = np.random.default_rng(11)
    g = random_genome(rng, 2400)
    seg = g[100:250]
    for at in (600, 1300):
        g = g[:at] + seg + g[at + 150:]
    g = g[:1900] + "A" * 120 + g[2020:]
    reads = [seg, g[1700:1760], "A" * 40 + g[2020:2060],
             random_genome(rng, 200), "ACG", ""]
    return g, reads


def _synthetic_case(rng, S=5, NK=300, NB=3, L=400, code_range=40):
    """Arbitrary index arrays the JAX function takes as they are: codes
    from a small range (runs of every length, some past max_occ) and
    positions in [-3000, 3000), so diagonals fall below 0 and past the
    last bin and the floor division meets negative values."""
    sc = np.sort(rng.integers(0, code_range, (NB, L)), axis=1).astype(np.int32)
    sc[:, L - 20:] = I32_MAX        # the pad of a short block
    sp = rng.integers(-3000, 3000, (NB, L)).astype(np.int32)
    qc = rng.integers(0, code_range + 5, (S, NK)).astype(np.int32)
    qv = rng.random((S, NK)) < 0.8
    qv[S - 1] = False               # a stream with no hit
    return qc, qv, sc, sp


def _seed_cases():
    g, reads = _genome_case()
    for k, BL, occ, max_occ, bin_w, T in ((11, 1024, 4, 64, 64, 8),
                                          (11, 1024, 2, 256, 32, 4),
                                          (6, 512, 4, 256, 64, 8)):
        NQ = 256
        sc, sp = _index_of(g, k, BL)
        q, lens = _encode(reads, NQ)
        qc, qv = _codes(q, lens, k)
        nbins = int(np.ceil((BL + NQ) / bin_w)) + 2
        yield (f"genome-k{k}-occ{occ}-max{max_occ}", (qc, qv, sc, sp),
               dict(NQ=NQ, nbins=nbins, bin_w=bin_w, occ=occ,
                    max_occ=max_occ, top_t=T))
    rng = np.random.default_rng(3)
    for max_occ, bin_w in ((8, 100), (30, 7)):
        arrays = _synthetic_case(rng)
        NQ = 256
        nbins = int(np.ceil((400 + NQ) / bin_w)) + 2
        yield (f"synthetic-max{max_occ}-binw{bin_w}", arrays,
               dict(NQ=NQ, nbins=nbins, bin_w=bin_w, occ=3,
                    max_occ=max_occ, top_t=6))


SEED_CASES = {name: (arrays, kw) for name, arrays, kw in _seed_cases()}


@pytest.fixture(scope="module")
def seed_jax():
    """The JAX function's (cnt, diag) for every case."""
    return {name: tuple(np.asarray(x) for x in jsh._seed_block_candidates(
        *(jnp.asarray(a) for a in arrays), **kw))
        for name, (arrays, kw) in SEED_CASES.items()}


@pytest.mark.parametrize("name", list(SEED_CASES))
def test_seed_plain_equals_jax(name, seed_jax):
    arrays, kw = SEED_CASES[name]
    got = tsh._seed_block_candidates_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    for w, t, what in zip(seed_jax[name], got, ("cnt", "diag")):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), w, err_msg=what)


@pytest.mark.parametrize("name", list(SEED_CASES))
def test_seed_model_equals_jax(name, seed_jax):
    arrays, kw = SEED_CASES[name]
    got = seed_model(*arrays, **kw)
    for w, t, what in zip(seed_jax[name], got, ("cnt", "diag")):
        np.testing.assert_array_equal(t, w, err_msg=what)


def test_seed_cases_plant_what_they_claim(seed_jax):
    """Every kind of row the kernel must get right is in the cases."""
    T = 8
    cnt, diag = seed_jax["genome-k11-occ4-max64"]
    # the empty row and the read shorter than k: bins 0 .. T-1 at 0
    for s in (4, 5):
        assert not cnt[s].any() and not diag[s].any()
    # fewer non-zero bins than T on the unique piece
    nz = (cnt[1] > 0).sum(axis=-1)
    assert 0 < nz.max() < T
    # equal non-zero counts in one (stream, block): the planted repeats
    row = cnt[0, 0]
    assert len(set(row[row > 0])) < (row > 0).sum()
    # max_occ drops the A run at 64 and counts it (cut by occ) at 256
    a_run = seed_jax["genome-k11-occ2-max256"][0][2].max()
    assert a_run > seed_jax["genome-k11-occ4-max64"][0][2].max()
    # the synthetic cases: negative diagonals, and zero rows
    cnt_s, diag_s = seed_jax["synthetic-max8-binw100"]
    assert (diag_s < 0).any() and not cnt_s[-1].any()


def test_seed_key_order_is_top_k_order():
    """The packed key orders bins as lax.top_k does: the larger count
    first, the lower bin among equals; zeros last, ascending."""
    nbins = 12
    h = np.array([0, 3, 3, 0, 5, 1, 3, 0, 0, 5, 0, 0], np.int32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(h), 9)[1])
    keys = h.astype(np.int64) * nbins + (nbins - 1 - np.arange(nbins))
    got = [nbins - 1 - int(k) % nbins for k in np.sort(keys)[::-1][:9]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [4, 9, 1, 2, 6, 5, 0, 3, 7])


@pytest.mark.parametrize("L", [63, 320, 321])
def test_seed_model_search_window_edges(L):
    """The search table's edges: blocks of fewer codes than the stride,
    of whole strides and one past, queried with every table code, its
    neighbours and codes past both ends, in runs that cross the table's
    entries; the model equals the JAX function."""
    rng = np.random.default_rng(L)
    stride = 1 << tsh.SEED_SHIFT
    sc = np.sort(rng.integers(0, L // 3, (2, L)), axis=1).astype(np.int32)
    sp = rng.integers(0, 600, (2, L)).astype(np.int32)
    at = np.concatenate([sc[:, ::stride].ravel(), sc[:, -1]])
    codes = np.concatenate([at - 1, at, at + 1, [-1, L, I32_MAX]])
    qc = rng.permutation(np.resize(codes, 256)).astype(np.int32)[None]
    qv = np.ones_like(qc, bool)
    kw = dict(NQ=256, nbins=int(np.ceil((600 + 256) / 16)) + 2, bin_w=16,
              occ=3, max_occ=12, top_t=8)
    want = jsh._seed_block_candidates(
        *(jnp.asarray(a) for a in (qc, qv, sc, sp)), **kw)
    got = seed_model(qc, qv, sc, sp, **kw)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t, np.asarray(w))
    assert np.asarray(want[0]).any()


def test_seed_shared_memory_of_the_gate_shapes():
    """The wide shape (bin_w = 32 at NQ = 131072, BL 200,064: L = 200,052
    codes at k = 13), the largest the aligner forms, needs more than the
    48 KB of static shared memory and fits the 227 KB; the source's
    stride and limit match the wrapper's."""
    src = open(os.path.join(_cuda.CSRC, "seed_mesh.cu")).read()
    threads = int(re.search(r"kSeedThreads = (\d+);", src).group(1))
    assert tsh.SEED_SMEM_MAX == 232448 - threads // 32 * 8
    shift = int(re.search(r"kSeedShift = (\d+);", src).group(1))
    assert tsh.SEED_SHIFT == shift
    L = 200052
    nbins = int(np.ceil((200064 + 131072) / 32)) + 2
    assert 48 * 1024 < tsh.seed_smem_bytes(nbins, L) <= tsh.SEED_SMEM_MAX
    nbins = int(np.ceil((200064 + 8192) / 128)) + 2
    assert nbins == 1629 and tsh.seed_smem_bytes(nbins, L) < 48 * 1024


# ---------------------------------------------------------------------------
# select_candidates_kernel


def select_model(cnt, tid, gdiag, *, K, min_hits, alpha, beta, bin_w,
                 prune=0.0, cap=tsh.SELECT_SHARED_ENTRIES):
    """select_candidates_kernel's algorithm in numpy, one read a row: the
    walk in the stable count order, 32 candidates a batch, a ballot of
    cnt >= min_hits, each candidate against the kept list (entry j in
    shared memory below ``cap``, in the spill past it, read by lane j mod
    32); the exact integer mean; the clamp; the prune against the largest
    kept score (0 while an entry was not kept); the first K by ballot
    ranks.  Returns (sel, idx, score), each (B, K)."""
    B, N = cnt.shape
    tid = np.broadcast_to(tid, (B, N))
    f32 = np.float32
    sel = np.zeros((B, K), bool)
    idx = np.zeros((B, K), np.int32)
    score = np.zeros((B, K), f32)
    for b in range(B):
        order = np.argsort(-cnt[b], kind="stable")
        shared, spill = [], []

        def entry(j):
            return shared[j] if j < cap else spill[j - cap]

        n_kept = 0
        for base in range(0, N, 32):
            batch = order[base:base + 32]
            ballot = [int(cnt[b, o]) >= min_hits for o in batch]
            for src in (l for l, v in enumerate(ballot) if v):
                o = int(batch[src])
                ti, gi = int(tid[b, o]), int(gdiag[b, o])
                near = [False] * 32
                for lane in range(32):
                    for j in range(lane, n_kept, 32):
                        t, g, _, _ = entry(j)
                        d = i32(g - gi)
                        if t == ti and (i32(-d) if d < 0 else d) <= bin_w:
                            near[lane] = True
                            break
                if not any(near):
                    (shared if n_kept < cap else spill).append(
                        (ti, gi, o, int(cnt[b, o])))
                    n_kept += 1
        total = sum(entry(j)[3] for j in range(n_kept))
        mean = f32(total) / f32(max(n_kept, 1))
        lo, hi = f32(alpha) * mean, f32(beta) * mean

        def clamp(c):
            return min(max(f32(c), lo), hi)

        thr = f32(0)
        if prune > 0.0:
            best = f32(0) if n_kept < N else f32(-np.inf)
            for j in range(n_kept):
                best = max(best, clamp(entry(j)[3]))
            thr = f32(prune) * best
        picked = 0
        for base in range(0, n_kept, 32):
            if picked >= K:
                break
            keep = []
            for j in range(base, min(base + 32, n_kept)):
                sc = clamp(entry(j)[3])
                keep.append((prune <= 0.0 or sc >= thr, entry(j)[2], sc))
            for ok, o, sc in keep:
                if ok:
                    if picked < K:
                        sel[b, picked], idx[b, picked] = True, o
                        score[b, picked] = sc
                    picked += 1
    return sel, idx, score


def _select_case(seed, B, N, *, n_tid=4, spread=400, cnt_hi=9,
                 wrap_rows=0):
    """Counts from a small range (ties), few targets on both strands,
    nearby diagonals; the first ``wrap_rows`` rows put half their
    candidates of target 1 at +-2^31 - 40 .. +-2^31, where the int32
    difference wraps to a small one."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, cnt_hi, (B, N)).astype(np.int32)
    ids = np.array([t for t in range(1, n_tid // 2 + 1)
                    for t in (t, -t)], np.int32)
    tid = rng.choice(ids, N).astype(np.int32)
    gdiag = rng.integers(0, spread, (B, N)).astype(np.int32)
    one = np.flatnonzero(tid == 1)
    for r in range(wrap_rows):
        hi_side = one[: len(one) // 2]
        lo_side = one[len(one) // 2:]
        gdiag[r, hi_side] = I32_MAX - rng.integers(0, 40, len(hi_side))
        gdiag[r, lo_side] = I32_MIN + rng.integers(0, 40, len(lo_side))
    return cnt, tid, gdiag


SELECT_CASES = {
    # N not a multiple of 32 and above 64; the prune off and on
    "n97-prune0": (_select_case(1, 12, 97), dict(K=40, min_hits=2,
                                                  prune=0.0)),
    "n97-prune0.81": (_select_case(1, 12, 97), dict(K=40, min_hits=2,
                                                     prune=0.81)),
    # K above the kept count (few targets, a wide bin)
    "k-past-kept": (_select_case(3, 8, 70, n_tid=2, spread=300),
                    dict(K=40, min_hits=1, prune=0.0, bin_w=128)),
    # min_hits 0: every candidate enters the walk
    "min-hits-0": (_select_case(4, 8, 200), dict(K=8, min_hits=0,
                                                  prune=0.3)),
    # +-2^31 on one target: the difference wraps
    "wrap": (_select_case(5, 6, 96, wrap_rows=4), dict(K=8, min_hits=2,
                                                        prune=0.81)),
    # the mesh phase's N = 96 and a 5 Mb target's N = 544
    "n96": (_select_case(6, 8, 96, cnt_hi=40, spread=20000),
            dict(K=8, min_hits=4, prune=0.81, bin_w=128)),
    "n544": (_select_case(7, 4, 544, n_tid=6, cnt_hi=40, spread=20000),
             dict(K=8, min_hits=4, prune=0.81, bin_w=128)),
}


def _select_kw(kw):
    return dict(dict(alpha=0.5, beta=2.0, bin_w=64), **kw)


@pytest.fixture(scope="module")
def select_jax():
    out = {}
    for name, ((cnt, tid, gdiag), kw) in SELECT_CASES.items():
        B, N = cnt.shape
        fn = functools.partial(jsh._select_read_candidates,
                               **_select_kw(kw))
        out[name] = tuple(np.asarray(x) for x in jax.vmap(fn)(
            jnp.asarray(cnt), jnp.broadcast_to(jnp.asarray(tid), (B, N)),
            jnp.asarray(gdiag)))
    return out


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_select_plain_equals_jax(name, select_jax):
    (cnt, tid, gdiag), kw = SELECT_CASES[name]
    got = tsh._select_read_candidates_ref(
        torch.from_numpy(cnt), torch.from_numpy(tid),
        torch.from_numpy(gdiag), **_select_kw(kw))
    for w, t, what in zip(select_jax[name], got, ("sel", "idx", "score")):
        assert t.numpy().dtype == w.dtype, what
        np.testing.assert_array_equal(t.numpy(), w, err_msg=what)


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_select_model_equals_jax(name, select_jax):
    (cnt, tid, gdiag), kw = SELECT_CASES[name]
    got = select_model(cnt, tid, gdiag, **_select_kw(kw))
    for w, t, what in zip(select_jax[name], got, ("sel", "idx", "score")):
        np.testing.assert_array_equal(t, w, err_msg=what)


def test_select_cases_plant_what_they_claim(select_jax):
    sel = {name: out[0] for name, out in select_jax.items()}
    assert (sel["k-past-kept"].sum(1) < 40).all()
    assert sel["k-past-kept"].any()
    # the prune drops candidates the unpruned selection keeps
    assert sel["n97-prune0"].sum() > sel["n97-prune0.81"].sum() > 0
    # the wrapped rows: candidates 2^32 - 80 apart count as near on target
    # 1, so fewer of target 1's are kept than with the wrap undone
    (cnt, tid, gdiag), kw = SELECT_CASES["wrap"]
    rows = slice(0, 4)
    one = tid == 1
    undone = gdiag.astype(np.int64)
    undone[undone < 0] += 1 << 32
    narrow = gdiag.copy()
    narrow[rows, one] = undone[rows, one] - (1 << 31) + 1000
    wide = gdiag[rows, one].astype(np.int64)
    assert np.ptp(wide) > 1 << 31 > np.ptp(narrow[rows, one])
    a = select_model(cnt, tid, gdiag, **_select_kw(dict(kw, K=96)))
    b = select_model(cnt, tid, narrow, **_select_kw(dict(kw, K=96)))
    for x, y in zip(a[:2], b[:2]):   # wrapped distance == true distance
        np.testing.assert_array_equal(x, y)


def test_select_model_spills_past_its_shared_entries():
    """A kept list longer than the shared entries (cap 5 here; 28,672 in
    the kernel) gives the same selection: the spill's indexing."""
    (cnt, tid, gdiag), kw = SELECT_CASES["n544"]
    kw = _select_kw(kw)
    full = select_model(cnt, tid, gdiag, **kw)
    small = select_model(cnt, tid, gdiag, cap=5, **kw)
    for a, b in zip(full, small):
        np.testing.assert_array_equal(a, b)


def test_select_shared_entries_match_the_source():
    """The wrapper's chunk and cap are the kernel's, and the cap's store
    fits the 227 KB of shared memory a block may have."""
    src = open(os.path.join(_cuda.CSRC, "seed_mesh.cu")).read()
    scan = int(re.search(r"kScan = (\d+);", src).group(1))
    chunks = int(re.search(r"kSelCap = (\d+) \* kChunk;", src).group(1))
    assert "kChunk = 32 * kScan;" in src
    assert tsh.SELECT_CHUNK == 32 * scan
    assert tsh.SELECT_SHARED_ENTRIES == chunks * tsh.SELECT_CHUNK
    assert tsh.SELECT_SHARED_ENTRIES * 8 <= 232448


# ---------------------------------------------------------------------------
# the wrappers' routes


def test_wrappers_take_the_plain_versions_on_cpu(monkeypatch):
    calls = []

    def spy(name):
        real = getattr(tsh, name)

        def call(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return call

    for name in ("_seed_block_candidates_ref", "_select_read_candidates_ref"):
        monkeypatch.setattr(tsh, name, spy(name))
    launches = (tsh.seed_block.launches, tsh.select_candidates.launches)
    arrays, kw = SEED_CASES["synthetic-max8-binw100"]
    got = tsh._seed_block_candidates(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    np.testing.assert_array_equal(got[0].numpy(), seed_model(*arrays, **kw)[0])
    (cnt, tid, gdiag), kw = SELECT_CASES["n97-prune0"]
    tsh._select_read_candidates(torch.from_numpy(cnt), torch.from_numpy(tid),
                                torch.from_numpy(gdiag), **_select_kw(kw))
    assert calls == ["_seed_block_candidates_ref",
                     "_select_read_candidates_ref"]
    assert (tsh.seed_block.launches,
            tsh.select_candidates.launches) == launches


def test_launch_functions_raise_on_cpu_tensors():
    arrays, kw = SEED_CASES["synthetic-max8-binw100"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsh.seed_block(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in arrays), **kw)
    (cnt, tid, gdiag), kw = SELECT_CASES["n97-prune0"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsh.select_candidates(torch.from_numpy(cnt), torch.from_numpy(tid),
                              torch.from_numpy(gdiag), **_select_kw(kw))
