"""The mesh seeder's two kernels (aligngraph2_tpu_torch/csrc/seed_mesh.cu)
on the CPU: their plain versions (``_seed_reads_ref``, which is
``kmer_codes_batch`` and ``_seed_block_candidates_ref`` a strand, and
``_select_read_candidates_ref`` of parallel/sharded.py) and a numpy model
of each kernel's algorithm, written here, against the JAX package's
``kmer_codes_batch``, ``_seed_block_candidates`` and
``_select_read_candidates`` on the cases the kernels must get right:

  * the histogram: a stream with no hit (top-T = bins 0 .. T-1 at count
    0), fewer non-zero bins than T, equal counts (the lower bin first),
    runs longer than max_occ, diagonals below 0 and past the last bin,
    ``occ`` cutting runs, the directory's edges, and
    both strands of reads with N bases and lengths short of NQ, their
    k-mer codes made from the bytes;
  * the dedup: N not a multiple of 32 and above 64, K above the kept
    count, min_hits 0, diagonals near +-2^31 on one target (the int32
    difference wraps), diagonals exactly 2^31 apart, pairs across the
    2^32 wrap where the circle's last bucket is short, two targets with
    equal diagonals, bursts of near-equal candidates inside one batch of
    32, and the prune off and on.

The models follow the kernels step by step: the k-mer code of each
position from the read's bytes, the directory's range of the code, a
lower bound in it, the run's end in the same range, the bin by a
multiply by bin_w's reciprocal, a list of the touched bins and top-T
rounds over them on the packed key sm_h * nbins + (nbins - 1 - bin); a
walk in the stable count order, 32 candidates a batch, each probing a table of kept entries keyed by (tid, gdiag //
(bin_w + 1)) in five buckets, the batch settled by its near matrix, an
exact integer mean, and a ballot-ranked first K.  Also: the wrappers take
the plain versions on CPU tensors, and the launch functions raise on CPU
tensors.  The planted dedup cases are chip_smoke.planted_select_cases,
which the card's gate also runs, and the clocked copy of the source that
the gates split by phase must still apply to it.  Every comparison is
exact."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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


def upper_bound(a, start, n, code):
    """The kernel's upper_bound over a[start .. start + n)."""
    lo = 0
    while n > 0:
        half = n >> 1
        if a[start + lo + half] <= code:
            lo += half + 1
            n -= half + 1
        else:
            n = half
    return lo


def make_div(d):
    """The kernel's reciprocal of d (make_div): (m, s1, s2)."""
    l = (d - 1).bit_length()
    return ((1 << 32) * ((1 << l) - d) // d + 1, min(l, 1), max(l - 1, 0))


def udiv(n, div):
    """n // d for 0 <= n < 2^32 by the reciprocal (udiv)."""
    m, s1, s2 = div
    t = (m * n) >> 32
    return (t + ((n - t) >> s1)) >> s2


def seed_dir(sc, dsh):
    """The kernel's directory of a block's sorted codes, with its two guard
    entries: d[j + 1] = the first i with sc[i] >= j << dsh for j in [0,
    2^SEED_DIR_BITS], d[0] = 0, d[-1] = len(sc); by a walk over sc."""
    D = 1 << tsh.SEED_DIR_BITS
    d = [0] * (D + 3)
    i = 0
    for j in range(D + 1):
        while i < len(sc) and sc[i] < j << dsh:
            i += 1
        d[j + 1] = i
    d[D + 2] = len(sc)
    return d


def seed_core(q_codes, q_valid, sorted_codes, sorted_pos, *, NQ, nbins,
              bin_w, occ, max_occ, top_t, dsh, bins=None):
    """seed_block_kernel's algorithm after the k-mer codes, in numpy: per
    (stream, block) the directory's range of the code (h = code >> dsh),
    a lower bound in it, a stop where the code is not at lo, the run by
    an upper bound in the same range, the first min(n, occ) hits into the
    bins (the bin by bin_w's reciprocal) with a list of touched bins,
    then top_t rounds of the largest packed key below the last winner
    over the touched bins and the untouched bins just below them.
    ``bins(s, blk)``, when given, returns the pair's (3, nbins) rows of
    hist, dsum and touched bins as the kernel's scratch holds them, not
    zeroed; else the bins are the model's own.  Returns cnt, diag (S, NB,
    T) int32."""
    S, NK = q_codes.shape
    NB, L = sorted_codes.shape
    D = 1 << tsh.SEED_DIR_BITS
    div = make_div(bin_w)
    cnt = np.zeros((S, NB, top_t), np.int32)
    diag = np.zeros((S, NB, top_t), np.int32)
    for blk in range(NB):
        sc = [int(x) for x in sorted_codes[blk]]
        sp = sorted_pos[blk]
        d = seed_dir(sc, dsh)
        for s in range(S):
            if bins is None:
                hist, dsum, slots = [0] * nbins, [0] * nbins, [0] * nbins
            else:
                hist, dsum, slots = bins(s, blk)
                hist[:] = 0   # the leader zeroes hist and dsum, not slots
                dsum[:] = 0
            touched = []
            for p in range(NK):
                if not q_valid[s, p]:
                    continue
                c = int(q_codes[s, p])
                h = min(max(c >> dsh, -1), D)
                a, e = d[h + 1], d[h + 2]
                lo = a + lower_bound(sc, a, e - a, c)
                if lo == e or sc[lo] != c:
                    continue
                n = upper_bound(sc, lo, e - lo, c)
                if n > max_occ:
                    continue
                for o in range(min(n, occ)):
                    dg = i32(int(sp[lo + o]) - p + NQ)
                    x = 0 if dg < 0 else min(udiv(dg, div), nbins - 1)
                    if hist[x] == 0:
                        slots[len(touched)] = x
                        touched.append(x)
                    hist[x] += 1
                    dsum[x] = i32(int(dsum[x]) + dg)
            last = None
            for t in range(top_t):
                keys = []
                for x in map(int, slots[:len(touched)]):
                    nxt = int(hist[x + 1]) if x + 1 < nbins else 0
                    keys.append((int(hist[x]) + nxt) * nbins
                                + (nbins - 1 - x))
                    if x > 0 and hist[x - 1] == 0:
                        keys.append(int(hist[x]) * nbins + (nbins - x))
                keys = [k for k in keys if last is None or k < last]
                if not keys:
                    break   # the rest stay (0, 0)
                last = max(keys)
                x = nbins - 1 - last % nbins
                h = int(hist[x]) + (int(hist[x + 1]) if x + 1 < nbins else 0)
                dd = i32(int(dsum[x]) + (int(dsum[x + 1]) if x + 1 < nbins
                                         else 0))
                cnt[s, blk, t] = h
                diag[s, blk, t] = i32(dd // h - NQ)
    return cnt, diag


def stream_codes(q_fwd, q_rev, read_lens, k, NQ):
    """The kernel's k-mer codes: stream s = 2 * read + strand, its position
    p valid iff p < len - (k - 1), its code the shift-or of the bytes at p
    .. p + k - 1 in 32 bits.  Returns codes, valid (2B, NQ - k + 1)."""
    B = q_fwd.shape[0]
    NK = NQ - k + 1
    codes = np.zeros((2 * B, NK), np.int64)
    valid = np.zeros((2 * B, NK), bool)
    for s in range(2 * B):
        q = (q_rev if s & 1 else q_fwd)[s >> 1]
        for p in range(NK):
            c = 0
            for j in range(k):
                c = ((c << 2) | int(q[p + j])) & 0xffffffff
            codes[s, p] = i32(c)
            valid[s, p] = p < int(read_lens[s >> 1]) - (k - 1)
    return codes, valid


def seed_model(q_fwd, q_rev, read_lens, sorted_codes, sorted_pos, *, k, NQ,
               nbins, bin_w, occ, max_occ, top_t):
    """seed_block_kernel in numpy, its bins in shared memory:
    :func:`stream_codes`, then :func:`seed_core` with the kernel's dsh =
    max(2k - SEED_DIR_BITS, 0).  Returns cnt, diag (B, 2, NB, T) int32."""
    B = q_fwd.shape[0]
    cnt, diag = seed_core(
        *stream_codes(q_fwd, q_rev, read_lens, k, NQ), sorted_codes,
        sorted_pos, NQ=NQ, nbins=nbins, bin_w=bin_w, occ=occ,
        max_occ=max_occ, top_t=top_t, dsh=tsh.seed_dir_shift(k))
    NB, T = cnt.shape[1:]
    return cnt.reshape(B, 2, NB, T), diag.reshape(B, 2, NB, T)


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
    """(name, code arrays, kw, the directory's shift for the model)."""
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
                    max_occ=max_occ, top_t=T),
               tsh.seed_dir_shift(k))
    rng = np.random.default_rng(3)
    for max_occ, bin_w, dsh in ((8, 100, 0), (30, 7, 2)):
        arrays = _synthetic_case(rng)
        NQ = 256
        nbins = int(np.ceil((400 + NQ) / bin_w)) + 2
        yield (f"synthetic-max{max_occ}-binw{bin_w}", arrays,
               dict(NQ=NQ, nbins=nbins, bin_w=bin_w, occ=3,
                    max_occ=max_occ, top_t=6), dsh)


SEED_CASES = {name: (arrays, kw, dsh)
              for name, arrays, kw, dsh in _seed_cases()}


@pytest.fixture(scope="module")
def seed_jax():
    """The JAX function's (cnt, diag) for every case."""
    return {name: tuple(np.asarray(x) for x in jsh._seed_block_candidates(
        *(jnp.asarray(a) for a in arrays), **kw))
        for name, (arrays, kw, _) in SEED_CASES.items()}


@pytest.mark.parametrize("name", list(SEED_CASES))
def test_seed_plain_equals_jax(name, seed_jax):
    arrays, kw, _ = SEED_CASES[name]
    got = tsh._seed_block_candidates_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    for w, t, what in zip(seed_jax[name], got, ("cnt", "diag")):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), w, err_msg=what)


@pytest.mark.parametrize("name", list(SEED_CASES))
def test_seed_model_equals_jax(name, seed_jax):
    arrays, kw, dsh = SEED_CASES[name]
    got = seed_core(*arrays, **kw, dsh=dsh)
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


@pytest.mark.parametrize("L", [31, 63, 320, 321])
def test_seed_model_search_window_edges(L):
    """The directory's edges: blocks whose codes fill ranges of one code
    (shift 0), of 16 and of 2^14 codes (the whole block in one range),
    queried with every code of the block, its neighbours, every range's
    bounds and codes past both ends and at the pad (INT32_MAX), in runs
    that cross range bounds; the model equals the JAX function, and the
    port's seed_directory equals the model's."""
    rng = np.random.default_rng(L)
    sc = np.sort(rng.integers(0, L // 3 + 2, (2, L)), axis=1).astype(np.int32)
    sc[1, L - 3:] = I32_MAX
    sp = rng.integers(0, 600, (2, L)).astype(np.int32)
    at = np.unique(sc)
    codes = np.concatenate([at - 1, at, at + 1, np.arange(0, L, 16),
                            [-1, -(1 << 20), L, I32_MAX]])
    qc = rng.permutation(np.resize(codes, 512)).astype(np.int32)[None]
    qv = np.ones_like(qc, bool)
    kw = dict(NQ=256, nbins=int(np.ceil((600 + 256) / 16)) + 2, bin_w=16,
              occ=3, max_occ=12, top_t=8)
    want = jsh._seed_block_candidates(
        *(jnp.asarray(a) for a in (qc, qv, sc, sp)), **kw)
    for dsh in (0, 4, 14):
        got = seed_core(qc, qv, sc, sp, **kw, dsh=dsh)
        for w, t in zip(want, got):
            np.testing.assert_array_equal(t, np.asarray(w))
    assert np.asarray(want[0]).any()
    for k in (2, 9, 13):
        dsh = tsh.seed_dir_shift(k)
        got = tsh.seed_directory(torch.from_numpy(sc), k).numpy()
        for b in range(2):
            np.testing.assert_array_equal(got[b], seed_dir(list(sc[b]), dsh))


def test_seed_reciprocal_is_exact():
    """The bin's multiply by bin_w's reciprocal equals the division for
    bin_w from 1 to 2^31 - 1 and dividends over the whole 32-bit range,
    both ends included."""
    rng = np.random.default_rng(7)
    ns = [0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
          *map(int, rng.integers(0, 1 << 32, 200, dtype=np.uint64))]
    for d in [1, 2, 3, 7, 32, 64, 100, 127, 128, 129, 255, 1000, 65537,
              (1 << 31) - 1, *map(int, rng.integers(1, 1 << 31, 40))]:
        div = make_div(d)
        assert div[0] < 1 << 32
        for n in ns + [d - 1, d, d + 1, 2 * d - 1, 2 * d]:
            assert udiv(n, div) == n // d, (n, d)


def _read_case(rng, g, NQ, B):
    """B reads of the genome at lengths short of NQ (one empty, one
    shorter than k; every other one from the reverse strand), with runs
    of N (encoded as A), mutated, and their reverse complements."""
    from aligngraph2_tpu_torch.io.seqdb import encode_seq, revcomp_codes
    from tests.synth import mutate, revcomp
    q_fwd = np.zeros((B, NQ), np.uint8)
    q_rev = np.zeros((B, NQ), np.uint8)
    lens = np.zeros(B, np.int32)
    for r in range(B):
        n = [0, 5][r] if r < 2 else int(rng.integers(NQ // 3, NQ - 10))
        at = int(rng.integers(0, len(g) - n))
        s = mutate(rng, g[at:at + n], 0.03, 0.01, 0.01)[:n]
        s = revcomp(s) if r % 2 else s
        if n > 40:
            cut = int(rng.integers(0, n - 30))
            s = s[:cut] + "N" * 25 + s[cut + 25:]
        c = encode_seq(s) if s else np.zeros(0, np.uint8)
        q_fwd[r, :len(c)] = c
        q_rev[r, :len(c)] = revcomp_codes(c)
        lens[r] = len(c)
    return q_fwd, q_rev, lens


def _read_cases():
    g, _ = _genome_case()
    rng = np.random.default_rng(21)
    for k, BL, bin_w, NQ in ((11, 1024, 64, 256), (7, 512, 32, 384)):
        sc, sp = _index_of(g, k, BL)
        yield (f"reads-k{k}-nq{NQ}", _read_case(rng, g, NQ, 5) + (sc, sp),
               dict(k=k, NQ=NQ, nbins=int(np.ceil((BL + NQ) / bin_w)) + 2,
                    bin_w=bin_w, occ=4, max_occ=64, top_t=8))


READ_CASES = {name: (arrays, kw) for name, arrays, kw in _read_cases()}


@pytest.fixture(scope="module")
def reads_jax():
    """Both strands through the JAX package's kmer_codes_batch and
    _seed_block_candidates, stacked as the port's (B, 2, NB, T)."""
    from aligngraph2_tpu.ops.kmer import kmer_codes_batch as jcodes
    out = {}
    for name, ((q_fwd, q_rev, lens, sc, sp), kw) in READ_CASES.items():
        kw = dict(kw)
        k = kw.pop("k")
        per = [jsh._seed_block_candidates(
            *jcodes(jnp.asarray(q), jnp.asarray(lens), k), jnp.asarray(sc),
            jnp.asarray(sp), **kw) for q in (q_fwd, q_rev)]
        out[name] = tuple(np.stack([np.asarray(x[j]) for x in per], 1)
                          for j in (0, 1))
    return out


@pytest.mark.parametrize("name", list(READ_CASES))
def test_seed_reads_plain_equals_jax(name, reads_jax):
    arrays, kw = READ_CASES[name]
    got = tsh._seed_reads_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    for w, t, what in zip(reads_jax[name], got, ("cnt", "diag")):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), w, err_msg=what)
    # real hits on both strands, and the empty and short rows at zero
    assert (w := reads_jax[name][0])[2:, 0].any() and w[2:, 1].any()
    assert not w[:2].any()


@pytest.mark.parametrize("name", list(READ_CASES))
def test_seed_reads_model_equals_jax(name, reads_jax):
    arrays, kw = READ_CASES[name]
    got = seed_model(*arrays, **kw)
    for w, t, what in zip(reads_jax[name], got, ("cnt", "diag")):
        np.testing.assert_array_equal(t, w, err_msg=what)


def test_seed_grid_fills_the_card():
    """The clusters of the gate's shapes on an H100's 132 SMs: C blocks
    split an (index block, stream) pair's positions where the pairs are
    fewer than 8 blocks an SM, as long as each thread keeps four
    positions; one block a pair where they are many.  A card of fewer
    SMs takes smaller clusters."""
    assert tsh.seed_grid(6, 64, 8180, 132) == 2
    assert tsh.seed_grid(6, 32, 16372, 132) == 4
    assert tsh.seed_grid(6, 16, 131060, 132) == 8
    assert tsh.seed_grid(600, 64, 8180, 132) == 1
    assert tsh.seed_grid(6, 64, 8180, 48) == 1
    assert tsh.seed_grid(6, 16, 131060, 48) == 4
    # a slice keeps four positions a thread or more; one pair still runs
    assert tsh.seed_grid(1, 2, 2000, 132) == 1
    assert tsh.seed_grid(10 ** 4, 1, 100, 132) == 1
    for NB, S, NK in ((6, 64, 8180), (6, 32, 16372), (6, 16, 131060)):
        C = tsh.seed_grid(NB, S, NK, 132)
        assert C == 1 or NK // C >= 4 * tsh.SEED_THREADS


def test_seed_shared_memory_of_the_gate_shapes():
    """The kernel's bins at the wide shape (bin_w = 32 at NQ = 131072, BL
    200,064), the largest the aligner forms, fit the 227 KB of a block;
    at the mesh's buckets as many blocks as an SM's 2048 threads allow
    fit its shared memory; the source's directory, threads and static
    arrays match the wrapper's."""
    src = open(os.path.join(_cuda.CSRC, "seed_mesh.cu")).read()
    threads = int(re.search(r"kSeedThreads = (\d+);", src).group(1))
    assert threads == tsh.SEED_THREADS
    # static: two rows of per-warp reduction keys and the touched count
    static = 232448 - tsh.SEED_SMEM_MAX
    assert static >= 2 * threads // 32 * 8 + 4
    assert tsh.SEED_DIR_BITS == int(
        re.search(r"kDirBits = (\d+);", src).group(1))
    nbins = int(np.ceil((200064 + 131072) / 32)) + 2
    assert 48 * 1024 < tsh.seed_smem_bytes(nbins) <= tsh.SEED_SMEM_MAX
    for NQ in (8192, 16384):
        nbins = int(np.ceil((200064 + NQ) / 128)) + 2
        # each block also holds 1 KB for the system; an SM has 228 KB
        assert (2048 // threads * (tsh.seed_smem_bytes(nbins) + static + 1024)
                <= 228 * 1024)


def seed_model_scratch(q_fwd, q_rev, read_lens, sorted_codes, sorted_pos, *,
                       k, NQ, nbins, bin_w, occ, max_occ, top_t):
    """seed_block_kernel with its bins in the scratch (past SEED_SMEM_MAX),
    in numpy: the launches seed_block makes, seed_launch_blocks(NB, 2B,
    nbins) index blocks each from blk0; in each, pair (stream s, block
    blk0 + y) owns row y * 2B + s of one scratch of 3 x nbins int32 a
    pair, reused unzeroed by the next launch, and the outputs land at
    blk0 + y.  Returns cnt, diag (B, 2, NB, T) int32."""
    B = q_fwd.shape[0]
    S, NB = 2 * B, sorted_codes.shape[0]
    codes, valid = stream_codes(q_fwd, q_rev, read_lens, k, NQ)
    cnt = np.zeros((S, NB, top_t), np.int32)
    diag = np.zeros((S, NB, top_t), np.int32)
    per = tsh.seed_launch_blocks(NB, S, nbins)
    scratch = np.full((per * S, 3, nbins), -7, np.int64)   # not zeroed
    for blk0 in range(0, NB, per):
        part = slice(blk0, min(blk0 + per, NB))
        cnt[:, part], diag[:, part] = seed_core(
            codes, valid, sorted_codes[part], sorted_pos[part], NQ=NQ,
            nbins=nbins, bin_w=bin_w, occ=occ, max_occ=max_occ,
            top_t=top_t, dsh=tsh.seed_dir_shift(k),
            bins=lambda s, y: scratch[y * S + s])
    return (cnt.reshape(B, 2, NB, top_t), diag.reshape(B, 2, NB, top_t))


def _wide_bins_case():
    """Reads at NQ = 512 against 640 kb blocks (k = 11, overlap a quarter)
    of a 1.5 Mb genome at bin_w 32, the band_width 64 seeder: ~20,000
    bins, past the 19,348 of one block's shared memory.  Reads from
    across each block, the far end of the first included (bins past
    19,348), one from the reverse strand, one empty."""
    from tests.synth import mutate, revcomp
    rng = np.random.default_rng(23)
    g = random_genome(rng, 1_500_000)
    k, BL, NQ, bin_w = 11, 640_000, 512, 32
    sc, sp = _index_of(g, k, BL)
    from aligngraph2_tpu_torch.io.seqdb import encode_seq, revcomp_codes
    B = 5
    q_fwd = np.zeros((B, NQ), np.uint8)
    q_rev = np.zeros((B, NQ), np.uint8)
    lens = np.zeros(B, np.int32)
    for r, at in enumerate((630_000, 20_000, 900_000, 1_300_000, None)):
        if at is None:
            continue
        s = mutate(rng, g[at:at + 480], 0.03, 0.01, 0.01)[:NQ]
        s = revcomp(s) if r == 2 else s
        c = encode_seq(s)
        q_fwd[r, :len(c)] = c
        q_rev[r, :len(c)] = revcomp_codes(c)
        lens[r] = len(c)
    nbins = int(np.ceil((BL + NQ) / bin_w)) + 2
    return (q_fwd, q_rev, lens, sc, sp), dict(
        k=k, NQ=NQ, nbins=nbins, bin_w=bin_w, occ=4, max_occ=64, top_t=8)


@pytest.fixture(scope="module")
def wide_bins():
    """The case, and both strands through the JAX package's
    kmer_codes_batch and _seed_block_candidates as (B, 2, NB, T)."""
    from aligngraph2_tpu.ops.kmer import kmer_codes_batch as jcodes
    (q_fwd, q_rev, lens, sc, sp), kw = _wide_bins_case()
    jkw = {n: v for n, v in kw.items() if n != "k"}
    per = [jsh._seed_block_candidates(
        *jcodes(jnp.asarray(q), jnp.asarray(lens), kw["k"]),
        jnp.asarray(sc), jnp.asarray(sp), **jkw) for q in (q_fwd, q_rev)]
    want = tuple(np.stack([np.asarray(x[j]) for x in per], 1)
                 for j in (0, 1))
    return (q_fwd, q_rev, lens, sc, sp), kw, want


def test_seed_plain_equals_jax_past_the_shared_bins(wide_bins):
    """_seed_reads_ref against the JAX seeder where the bins pass what
    one block's shared memory holds (the card's scratch layout): every
    output equal, and the case has what it claims (bins past 19,348, the
    far end's read found there)."""
    arrays, kw, want = wide_bins
    assert kw["nbins"] > 19_348 and tsh.seed_bins_in_scratch(kw["nbins"])
    got = tsh._seed_reads_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in arrays), **kw)
    for w, t, what in zip(want, got, ("cnt", "diag")):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=what)
    cnt, diag = want
    far = diag[0, 0, 0, 0] + kw["NQ"]   # read 0 at 630 kb of block 0
    assert cnt[0, 0, 0, 0] > 50 and far // kw["bin_w"] > 19_348
    assert cnt[2, 1].any() and not cnt[4].any()


@pytest.mark.parametrize("budget", [None, 3])
def test_seed_model_with_scratch_bins_equals_jax(wide_bins, budget,
                                                 monkeypatch):
    """The model of the kernel's scratch layout (seed_model_scratch)
    equals the JAX seeder past the shared bins: with the wrapper's
    scratch budget (one launch for the case's blocks), and with a budget
    of one block's pairs a launch (three launches, blk0 0, 1 and 2, the
    scratch left unzeroed between them)."""
    arrays, kw, want = wide_bins
    NB = arrays[3].shape[0]
    assert NB == 3
    if budget is not None:
        monkeypatch.setattr(tsh, "SEED_SCRATCH_BYTES",
                            2 * 5 * tsh.seed_smem_bytes(kw["nbins"]))
    per = tsh.seed_launch_blocks(NB, 10, kw["nbins"])
    assert per == (NB if budget is None else 1)
    got = seed_model_scratch(*arrays, **kw)
    for w, t, what in zip(want, got, ("cnt", "diag")):
        np.testing.assert_array_equal(t, w, err_msg=what)


def test_seed_bins_path_at_its_edge():
    """The wrapper keeps a pair's bins in its cluster leader's shared
    memory up to 19,348 bins (12 bytes a bin within SEED_SMEM_MAX) and in
    the scratch past it, in launches of the index blocks whose pairs' bins
    fit SEED_SCRATCH_BYTES (at least one block); at -b 1000 (1 Mb blocks)
    the aligner's seeder takes the scratch at band_width 64 and below at
    every bucket and at 128 past the 131072 bucket, and shared memory at
    256 up to the 1 Mb bucket."""
    assert tsh.SEED_SMEM_MAX // 12 == 19_348
    assert not tsh.seed_bins_in_scratch(19_348)
    assert tsh.seed_bins_in_scratch(19_349)
    assert tsh.seed_launch_blocks(600, 64, 19_348) == 600
    pair = tsh.seed_smem_bytes(19_349)
    fit = tsh.SEED_SCRATCH_BYTES // (64 * pair)
    assert tsh.seed_launch_blocks(600, 64, 19_349) == fit
    assert tsh.seed_launch_blocks(fit - 1, 64, 19_349) == fit - 1
    assert tsh.seed_launch_blocks(7, 64, 10 ** 8) == 1

    def nbins(band_width, NQ, BL=1_000_000):
        return int(np.ceil((BL + NQ) / max(band_width // 2, 32))) + 2
    for NQ in (8192, 131072, 1 << 20):
        assert tsh.seed_bins_in_scratch(nbins(32, NQ))
        assert tsh.seed_bins_in_scratch(nbins(64, NQ))
        assert not tsh.seed_bins_in_scratch(nbins(256, NQ))
    assert not tsh.seed_bins_in_scratch(nbins(128, 131072))
    assert tsh.seed_bins_in_scratch(nbins(128, 262144))
    assert nbins(32, 8192) == 31_508 and nbins(32, 131072) == 35_348


# ---------------------------------------------------------------------------
# select_candidates_kernel


def near(gj, gi, bin_w):
    """The kernel's near: the int32 difference wraps, |INT_MIN| stays
    INT_MIN (so it is near at any bin_w >= 0)."""
    d = i32(gj - gi)
    return d == I32_MIN or -bin_w <= d <= bin_w


def select_buckets(g, bin_w, div):
    """The five buckets a candidate probes: its arc's two ends, its own,
    the circle's last (short) one, and the one 2^31 away."""
    u = g & 0xffffffff
    return [udiv((u - bin_w) & 0xffffffff, div), udiv(u, div),
            udiv((u + bin_w) & 0xffffffff, div), udiv(0xffffffff, div),
            udiv(u ^ 0x80000000, div)]


def select_model(cnt, tid, gdiag, *, K, min_hits, alpha, beta, bin_w,
                 prune=0.0, buckets=select_buckets):
    """select_candidates_kernel's algorithm in numpy, one read a row: the
    walk in the stable count order, 32 candidates a batch; each candidate
    past min_hits probes the table of kept entries, keyed by (tid, gdiag
    // (bin_w + 1)), in the buckets ``buckets`` gives and tests each found
    entry exactly; the batch's survivors near an earlier survivor
    (``conf``) are settled in order against the kept mask, the others
    kept outright; the kept insert themselves.  Then the exact integer
    mean; the clamp; the prune against the largest kept score (0 while an
    entry was not kept); the first K by ballot ranks.  Returns (sel, idx,
    score), each (B, K)."""
    B, N = cnt.shape
    tid = np.broadcast_to(tid, (B, N))
    f32 = np.float32
    div = make_div(bin_w + 1)
    sel = np.zeros((B, K), bool)
    idx = np.zeros((B, K), np.int32)
    score = np.zeros((B, K), f32)
    for b in range(B):
        order = np.argsort(-cnt[b], kind="stable")
        table = {}
        kept = []   # (order index, count), in order
        for base in range(0, N, 32):
            batch = [int(o) for o in order[base:base + 32]]
            t = [int(tid[b, o]) for o in batch]
            g = [int(gdiag[b, o]) for o in batch]
            sv = 0
            for lane, o in enumerate(batch):
                if cnt[b, o] < min_hits:
                    continue
                if not any((t[lane], bk) in table
                           and near(table[t[lane], bk], g[lane], bin_w)
                           for bk in buckets(g[lane], bin_w, div)):
                    sv |= 1 << lane
            nm = [sum(1 << i for i in range(lane) if t[i] == t[lane]
                      and near(g[i], g[lane], bin_w))
                  for lane in range(len(batch))]
            conf = sum(1 << j for j in range(len(batch))
                       if sv >> j & 1 and nm[j] & sv)
            keep = sv & ~conf
            for j in range(len(batch)):
                if conf >> j & 1 and not nm[j] & keep:
                    keep |= 1 << j
            for lane, o in enumerate(batch):
                if keep >> lane & 1:
                    key = (t[lane], udiv(g[lane] & 0xffffffff, div))
                    assert key not in table   # a bucket holds one a tid
                    table[key] = g[lane]
                    kept.append((o, int(cnt[b, o])))
        n_kept = len(kept)
        mean = f32(sum(c for _, c in kept)) / f32(max(n_kept, 1))
        lo, hi = f32(alpha) * mean, f32(beta) * mean

        def clamp(c):
            return min(max(f32(c), lo), hi)

        thr = f32(0)
        if prune > 0.0:
            best = f32(0) if n_kept < N else f32(-np.inf)
            for _, c in kept:
                best = max(best, clamp(c))
            thr = f32(prune) * best
        picked = 0
        for o, c in kept:
            sc = clamp(c)
            if prune <= 0.0 or sc >= thr:
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


SELECT_CASES.update(chip_smoke.planted_select_cases())


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
    # the burst: one of the 40 near-equal kept; the chain keeps every other
    (cnt, tid, gdiag), kw = SELECT_CASES["burst"]
    idx = select_jax["burst"][1]
    got = set(idx[0][select_jax["burst"][0][0]])
    assert len(got & set(range(40))) == 1
    got = set(idx[1][select_jax["burst"][0][1]])
    assert got & set(range(60)) == set(range(0, 60, 2))
    # both targets keep the same diagonals
    sel, idx, _ = select_jax["two-targets"]
    for r in range(4):
        kept = idx[r][sel[r]]
        assert set(kept[kept < 32]) == {i - 32 for i in kept[kept >= 32]}


@pytest.mark.parametrize("drop", range(5))
def test_select_probes_are_all_needed(drop):
    """Each of the five buckets a candidate probes decides some case: the
    model without it differs from the JAX function on one."""
    def fewer(g, bin_w, div):
        bk = select_buckets(g, bin_w, div)
        return bk[:drop] + bk[drop + 1:]

    differs = []
    for name, ((cnt, tid, gdiag), kw) in SELECT_CASES.items():
        want = select_model(cnt, tid, gdiag, **_select_kw(kw))
        try:
            got = select_model(cnt, tid, gdiag, buckets=fewer,
                               **_select_kw(kw))
        except AssertionError:   # two kept entries in one bucket
            differs.append(name)
            continue
        differs += [name for w, g in zip(want, got)
                    if not np.array_equal(w, g)][:1]
    assert differs


def test_select_table_goes_to_scratch_past_its_shared_slots():
    """The table holds at least twice the candidates (a load of one half
    at most), a power of two; up to N = 8192 it is in shared memory, past
    that in the wrapper's scratch."""
    for N in (1, 31, 32, 33, 96, 544, 8192, 8193, 12800, 32768):
        slots = tsh.select_slots(N)
        assert slots >= 2 * N and slots & (slots - 1) == 0 and slots >= 64
        assert slots < 4 * N or slots == 64
        assert (slots <= tsh.SELECT_SHARED_SLOTS) == (N <= 8192)


def test_select_shared_entries_match_the_source():
    """The wrapper's shared slots are the kernel's, and they fit the 227
    KB of shared memory a block may have."""
    src = open(os.path.join(_cuda.CSRC, "seed_mesh.cu")).read()
    shift = int(re.search(r"kSelSharedSlots = 1 << (\d+);", src).group(1))
    assert tsh.SELECT_SHARED_SLOTS == 1 << shift
    assert tsh.SELECT_SHARED_SLOTS * 8 <= 232448


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

    for name in ("_seed_reads_ref", "_select_read_candidates_ref"):
        monkeypatch.setattr(tsh, name, spy(name))
    launches = (tsh.seed_block.launches, tsh.select_candidates.launches)
    arrays, kw = READ_CASES["reads-k7-nq384"]
    sc = torch.from_numpy(arrays[3])
    got = tsh._seed_reads(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        tsh.seed_directory(sc, kw["k"]), **kw)
    np.testing.assert_array_equal(got[0].numpy(), seed_model(*arrays, **kw)[0])
    (cnt, tid, gdiag), kw = SELECT_CASES["n97-prune0"]
    tsh._select_read_candidates(torch.from_numpy(cnt), torch.from_numpy(tid),
                                torch.from_numpy(gdiag), **_select_kw(kw))
    assert calls == ["_seed_reads_ref", "_select_read_candidates_ref"]
    assert (tsh.seed_block.launches,
            tsh.select_candidates.launches) == launches


def test_clocked_copy_applies_to_the_source():
    """chip_smoke's phase timers edit the committed source: each anchor
    once, a mark for every phase of both kernels, the clock reset and
    read functions appended."""
    src = open(os.path.join(_cuda.CSRC, "seed_mesh.cu")).read()
    out = chip_smoke.clocked_seed_source(src)
    for k in range(5):
        assert out.count(f"CLK({k});") >= 2
    assert out.count(chip_smoke._CLK_INIT) == 2
    assert out.count("CLK_SAVE();") == 4
    assert 'extern "C" int agc_read_clk' in out
    assert 'extern "C" int agc_reset_clk' in out
    for kernel, names in chip_smoke.SEED_PHASES.items():
        assert kernel in src and len(names) == 5
    with pytest.raises(ValueError, match="occurrences"):
        chip_smoke.clocked_seed_source(src.replace("  if (!lead) return;\n",
                                                   ""))


def test_launch_functions_raise_on_cpu_tensors():
    arrays, kw = READ_CASES["reads-k7-nq384"]
    sc = torch.from_numpy(arrays[3])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsh.seed_block(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in arrays), tsh.seed_directory(sc, kw["k"]),
                       **kw)
    (cnt, tid, gdiag), kw = SELECT_CASES["n97-prune0"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsh.select_candidates(torch.from_numpy(cnt), torch.from_numpy(tid),
                              torch.from_numpy(gdiag), **_select_kw(kw))
