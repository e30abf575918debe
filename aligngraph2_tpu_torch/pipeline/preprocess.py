"""Contig-to-reference grouping — the ``pre_process`` stage.

Copy of ``aligngraph2_tpu/pipeline/preprocess.py``.

Re-implements AlignGraph2 PAGraph/src/main/pre_process.cpp:23-99:
per contig, a coverage bitmask per (reference, orientation) over the
contig's forward coordinates; (ref, orient) pairs covering >= ratio of
the contig survive; the top-K (default 1) per contig by covered-base
count vote for their reference; references keeping >= 2 distinct contigs
become groups.  When both orientations of a contig voted for a reference,
the first in (name, orientation) order wins — with false < true, i.e.
the REVERSE orientation (faithful to the std::set iteration order in
pre_process.cpp:84-96).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from ..align.records import AlignmentSet
from ..graph.processor import GroupSpec
from ..io.seqdb import SeqDatabase


def group_contigs(ctg_db: SeqDatabase, ctg_to_ref: AlignmentSet,
                  top_k: int = 1, ratio: float = 0.15) -> List[GroupSpec]:
    cover: Dict[Tuple[int, str, bool], np.ndarray] = {}
    for a in ctg_to_ref:
        cid = ctg_db.seq_id(a.query_name)
        if cid < 0:
            continue
        key = (cid, a.ref_name, a.forward)
        if key not in cover:
            cover[key] = np.zeros(a.qsize, dtype=bool)
        cover[key][a.qb:a.qe] = True

    ref_with_ctg: Dict[str, Set[Tuple[str, bool]]] = {}
    for cid in range(len(ctg_db)):
        votes = []
        for (c, ref, fwd), mask in cover.items():
            if c != cid:
                continue
            cnt = int(mask.sum())
            if cnt / len(mask) >= ratio:
                votes.append((cnt, ref, fwd))
        # sort by count descending; ties keep the (ref, fwd) order the
        # reference's std::map iteration would give
        votes.sort(key=lambda v: (-v[0], v[1], v[2]))
        for cnt, ref, fwd in votes[:top_k]:
            ref_with_ctg.setdefault(ref, set()).add(
                (ctg_db.name(cid), fwd))

    groups: List[GroupSpec] = []
    for ref in sorted(ref_with_ctg):
        members = ref_with_ctg[ref]
        if len(members) <= 1:
            continue
        seen: Set[str] = set()
        contigs: List[Tuple[str, bool]] = []
        for name, fwd in sorted(members):  # false < true: reverse first
            if name in seen:
                continue
            seen.add(name)
            contigs.append((name, fwd))
        groups.append(GroupSpec(ref_name=ref, contigs=contigs))
    return groups


def write_config(path: str, groups: List[GroupSpec]) -> None:
    """config.txt manifest (pre_process.cpp:271-287 format)."""
    with open(path, "w") as f:
        for i, g in enumerate(groups):
            f.write(f"{g.ref_name}\n")
            f.write(f"{i}.new.fastq\n{i}.ctg.ref\n{i}.ref.ref\n")
            for name, fwd in g.contigs:
                f.write(f"{name}\n{1 if fwd else 0}\n")
            f.write("\n")


def read_config(path: str) -> List[GroupSpec]:
    """Parse a config.txt manifest back into GroupSpecs (inverse of
    write_config; same format pagraph itself parses, pagraph.cpp:29-49)."""
    groups: List[GroupSpec] = []
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        ref_name = lines[i]
        i += 4  # skip the three per-group file names
        contigs: List[Tuple[str, bool]] = []
        while i + 1 < len(lines) and lines[i]:
            contigs.append((lines[i], lines[i + 1] == "1"))
            i += 2
        groups.append(GroupSpec(ref_name=ref_name, contigs=contigs))
    return groups


def group_read_names(group: GroupSpec, read_to_ctg: AlignmentSet,
                     read_to_ref: AlignmentSet) -> Set[str]:
    """Reads belonging to a group: any read aligned to a member contig or
    to the group reference (pre_process.cpp filterReadAndRef)."""
    member_ctgs = {name for name, _ in group.contigs}
    out: Set[str] = set()
    for a in read_to_ctg:
        if a.ref_name in member_ctgs:
            out.add(a.query_name)
    for a in read_to_ref:
        if a.ref_name == group.ref_name:
            out.add(a.query_name)
    return out


def subset_alignments(alns: AlignmentSet, query_names: Set[str] | None,
                      target_names: Set[str] | None) -> AlignmentSet:
    out = AlignmentSet()
    for a in alns:
        if query_names is not None and a.query_name not in query_names:
            continue
        if target_names is not None and a.ref_name not in target_names:
            continue
        out.append(a)
    return out
