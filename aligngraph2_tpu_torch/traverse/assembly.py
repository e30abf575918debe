"""Per-group assembly: travel every contig, build the connection digraph
from leap targets, union-find chains, and emit connected/extended contigs.

Copy of ``aligngraph2_tpu/traverse/assembly.py``.

Re-implements PAssembly::testTravel5
(AlignGraph2 PAGraph/src/tools/graph/PAssembly.cpp:10-336):
  * travels shorter than 0.9 * startSplit * ctgLen are dropped;
  * leap targets add in-degrees; dangling edges (target produced no
    travel) are cleaned by popping the leaping node;
  * union-find over connection chains, one representative per component
    (the longest chain by summed contig lengths);
  * a chain is emitted iff connected (>1 contig and total travel length
    > 1.05 * longest member contig) or extended (single contig whose
    travel > 1.2 * its length);
  * outputs: per-chain FASTA, .help (lengths), .con (connection info),
    per-travel debug .txt, and the set of consumed contigs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..io.fasta import LINE_WIDTH
from .walk import Travel, TravelState, seq_size, seq_to_string, \
    travel_sequence


class UnionSet:
    """Path-compressing union-find (graph/UnionSet.cpp)."""

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, left: int, right: int) -> None:
        self.parent[self.find(right)] = self.find(left)


@dataclass
class AssemblyResult:
    success: Set[Tuple[str, bool]] = field(default_factory=set)
    fastas: List[str] = field(default_factory=list)       # emitted paths
    connections: List[dict] = field(default_factory=list)  # .con info


def _slot(ctg_idx: int, forward: bool) -> int:
    return 2 * ctg_idx + (0 if forward else 1)


def _combat_seq(results: List[Travel], st: TravelState, start_idx: int,
                start_fwd: bool, functor) -> None:
    """Walk a connection chain (PAssembly::combatSeq): follow each travel's
    final leap target until a repeat, an empty travel, or functor says
    stop."""
    next_slot = _slot(start_idx, start_fwd)
    next_pos = 0
    seen = {next_slot}
    while True:
        go = functor(next_slot // 2, next_slot % 2 == 0, next_pos)
        if not go:
            break
        seq = results[next_slot]
        if not seq or int(st.graph.pos_ctg[seq[-1][1]]) == 0:
            break
        di, dp = st.ctg_mapper.single_to_dual(
            int(st.graph.pos_ctg[seq[-1][1]]))
        next_pos = int(dp)
        next_slot = _slot(abs(di) - 1, di > 0)
        if next_slot in seen:
            break
        seen.add(next_slot)


def assemble_group(st: TravelState, ctg_set: List[Tuple[str, bool]],
                   out_dir: Optional[str], prefix: str) -> AssemblyResult:
    ctgs = st.ctgs
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    n = len(ctgs)
    results: List[Travel] = [[] for _ in range(2 * n)]
    in_degrees = np.zeros(2 * n, np.int64)
    res = AssemblyResult()

    # --- travel every (contig, orientation) of the group ---
    # travels are independent (each owns its levels; graph arrays are
    # read-only) and run in parallel like the reference's threadNum/8-wide
    # loop (PAssembly.cpp:30); the first travel runs alone to warm the
    # native handle, and results are consumed in ctg_set order so the
    # outcome is bit-identical to the serial loop
    items = [(name, fwd, ctgs.seq_id(name)) for name, fwd in ctg_set]
    travels: List[Travel] = []
    if items:
        travels.append(travel_sequence(st, items[0][2], items[0][1]))
    if len(items) > 1:
        t_threads = st.threads if st.threads > 0 else (os.cpu_count() or 1)
        t_threads = max(1, min(t_threads // 8 + 1, len(items) - 1))
        if t_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(t_threads) as ex:
                travels.extend(ex.map(
                    lambda it: travel_sequence(st, it[2], it[1]),
                    items[1:]))
        else:
            travels.extend(travel_sequence(st, it[2], it[1])
                           for it in items[1:])
    for (name, fwd, cid), travel in zip(items, travels):
        slot = _slot(cid, fwd)
        if out_dir:
            _dump_travel(st, out_dir, prefix, cid, fwd, travel, name)
        if seq_size(travel) < ctgs.size(cid) * st.start_split * 0.9:
            travel = []
        results[slot] = travel
        if travel:
            last_c = int(st.graph.pos_ctg[travel[-1][1]])
            if last_c != 0:
                di, _ = st.ctg_mapper.single_to_dual(last_c)
                tgt = _slot(abs(di) - 1, di > 0)
                if tgt != slot:
                    in_degrees[tgt] += 1

    # --- dangling-edge cleanup ---
    for name, fwd in ctg_set:
        cid = ctgs.seq_id(name)
        slot = _slot(cid, fwd)
        if results[slot]:
            last_c = int(st.graph.pos_ctg[results[slot][-1][1]])
            if last_c != 0:
                di, _ = st.ctg_mapper.single_to_dual(last_c)
                tgt = _slot(abs(di) - 1, di > 0)
                if tgt != slot and not results[tgt]:
                    results[slot].pop()
                    in_degrees[tgt] -= 1

    # --- union-find over connection chains ---
    table = list(ctg_set)
    helper = {name_fwd: i for i, name_fwd in enumerate(table)}
    touched = [False] * len(table)
    uf = UnionSet(len(table))
    for name, fwd in ctg_set:
        cid = ctgs.seq_id(name)
        slot = _slot(cid, fwd)
        if in_degrees[slot] > 0 or not results[slot]:
            continue
        main_idx = helper[(name, fwd)]
        touched[main_idx] = True

        def chain(ctg_id, forward, start_pos, _cid=cid, _fwd=fwd,
                  _main=main_idx):
            if ctg_id != _cid or forward != _fwd:
                h = helper[(ctgs.name(ctg_id), forward)]
                uf.union(h, _main)
                if touched[h]:
                    return False
                touched[h] = True
            return True

        _combat_seq(results, st, cid, fwd, chain)

    merged: Dict[int, List[int]] = {}
    for i in range(len(table)):
        merged.setdefault(uf.find(i), []).append(i)

    chosen_set: Set[Tuple[str, bool]] = set()
    for members in merged.values():
        max_size = 0
        chosen = members[0]
        for idx in members:
            name, fwd = table[idx]
            cid = ctgs.seq_id(name)
            slot = _slot(cid, fwd)
            if in_degrees[slot] > 0 or not results[slot]:
                continue
            total = [0]

            def add_len(ctg_id, forward, start_pos):
                total[0] += ctgs.size(ctg_id)
                return True

            _combat_seq(results, st, cid, fwd, add_len)
            if total[0] > max_size:
                max_size = total[0]
                chosen = idx
        chosen_set.add(table[chosen])

    # --- emission ---
    name_cnt = 0
    for name, fwd in sorted(chosen_set):
        cid = ctgs.seq_id(name)
        slot = _slot(cid, fwd)
        if in_degrees[slot] > 0 or not results[slot]:
            continue
        connected: Set[Tuple[int, bool]] = set()
        max_len = [0]
        total_len = [0]

        def gather(ctg_id, forward, start_pos):
            connected.add((ctg_id, forward))
            max_len[0] = max(max_len[0], ctgs.size(ctg_id))
            total_len[0] += seq_size(results[_slot(ctg_id, forward)])
            return True

        _combat_seq(results, st, cid, fwd, gather)

        is_connected = len(connected) > 1 and \
            total_len[0] > max_len[0] * 1.05
        is_extended = len(connected) == 1 and \
            seq_size(results[slot]) > ctgs.size(cid) * 1.2
        if not (is_connected or is_extended):
            continue

        new_name = f"{prefix}{name_cnt}"
        name_cnt += 1
        chunks: List[str] = []
        con_inf: List[Tuple[str, bool, int]] = []

        def emit(ctg_id, forward, start_pos):
            con_inf.append((ctgs.name(ctg_id), forward, ctgs.size(ctg_id)))
            chunks.append(seq_to_string(
                st, results[_slot(ctg_id, forward)]))
            return True

        _combat_seq(results, st, cid, fwd, emit)
        seq = "".join(chunks)

        if out_dir:
            base = os.path.join(out_dir,
                                f"{prefix}{slot // 2}_{slot % 2}")
            with open(base + ".help", "w") as f:
                f.write(f"{total_len[0]}\n{max_len[0]}\n")
            with open(base + ".fasta", "w") as f:
                f.write(f">{new_name}\n")
                for i in range(0, len(seq), LINE_WIDTH):
                    f.write(seq[i:i + LINE_WIDTH] + "\n")
            with open(base + ".con", "w") as f:
                f.write(f"{new_name}\t{len(seq)}\n")
                for cname, cfwd, clen in con_inf:
                    f.write(f"{cname}\t{'FORWARD' if cfwd else 'REV'}"
                            f"\t{clen}\n")
            res.fastas.append(base + ".fasta")
        res.connections.append({
            "name": new_name, "length": len(seq),
            "members": con_inf, "sequence": seq})
        for ctg_id, forward in connected:
            res.success.add((ctgs.name(ctg_id), forward))
    return res


def _dump_travel(st: TravelState, out_dir: str, prefix: str, cid: int,
                 fwd: bool, travel: Travel, name: str) -> None:
    """Per-travel debug dump (PAssembly.cpp:40-54) — the reference's
    de-facto correctness oracle.  Columns are precomputed vectorized
    (mapper lookups, k-mer decode); the scalar per-step version cost
    tens of seconds per group at genome scale."""
    path = os.path.join(out_dir, f"{prefix}{cid}_{0 if fwd else 1}.txt")
    g = st.graph
    k = g.k
    with open(path, "w") as f:
        f.write(f"{name}\t{st.ctgs.size(cid)}\n")
        if not travel:
            return
        arr = np.asarray(travel, dtype=np.int64)       # (n, 3)
        nd, pi, dist = arr[:, 0], arr[:, 1], arr[:, 2]
        c = g.pos_ctg[pi].astype(np.int64)
        r = g.pos_ref[pi].astype(np.int64)
        cnt = g.pos_count[pi]
        ci, cp = st.ctg_mapper.single_to_dual(c)
        ri, rp = st.ref_mapper.single_to_dual(r)
        # decode every step's k-mer in one shot: (n, k) base matrix
        shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.int64)
        bases = (g.node_codes[nd][:, None] >> shifts[None, :]) & 3
        chars = np.frombuffer(b"ACGT", np.uint8)[bases]
        kmers = chars.tobytes().decode("ascii")
        f.writelines(
            f"{kmers[i * k:(i + 1) * k]},{c[i]},{r[i]},{cnt[i]}\t{dist[i]}"
            f"\t{ci[i]},{cp[i]}\t{ri[i]},{rp[i]}\n"
            for i in range(len(arr)))
