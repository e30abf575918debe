"""End-to-end pipeline driver.

Counterpart of ``aligngraph2_tpu/pipeline/driver.py``, which replaces
AlignGraph2 AlignGraph2.py:121-529: the 8-stage flow with per-stage
content-addressed caching, the same working-directory layout, and the
same final outputs (final.fasta, remainder.fasta, exclude.fasta,
add.fasta, connect_info.txt).

Stages:
  1. solid k-mer set                 (kmer_counter)
  2. reads -> contigs alignment      (mecat2ref)
  3. reads -> similar genome         (mecat2ref+ / fallback)
  4. contigs -> similar genome       (long2ref / nucmer+paf2aln)
  5. contig grouping                 (pre_process + split_helper)
  6. per-group graph build+traversal (pagraph) and merge
  7. extract + reads -> new contigs  (extract.py + mecat2ref + split)
  8. windowed consensus + merge      (pa_cns + merge)

The aligner stages (2, 3 with its seed rescue, 4 and 7) run on
``cfg.runtime.device``: the static band's CUDA kernels on ``cuda`` (the
default; raises without a card, with no fallback to the CPU), the
adaptive band on ``cpu``, whose files equal the JAX package's on the CPU
byte for byte.  ``cfg.runtime.plain`` runs the static band through its
plain torch versions.  Under the mesh (``cfg.runtime.sharded_align``;
by default on when the device is ``cuda`` and more than one card is
present, as the JAX package's rule is more than one local device) the
aligner stages take the mesh path over the local cards, or over the one
CPU device.

Several processes (``parallel/distributed.py``, ``torch.distributed``)
split the work as the JAX package's hosts do: stage 1 counts each
process's share of the reads and merges the counts; stages 2, 3 and 7
align each process's share of the reads and gather the alignments;
stage 6 runs group i on process i mod n and gathers the results; stage
8 corrects backbone i on process i mod n; the coordinator (rank 0) alone
writes the stage files and outputs, behind barriers, and each process
keeps its own alignment checkpoint.  Each stage's reuse decision is the
coordinator's, broadcast to every process (``agreed``): the JAX driver
lets each host read the stage cache while the coordinator may already be
rewriting it, and a host that saw the new cache skipped a barrier that
the others waited in.  With one process every helper is the identity.

Left out: the XLA compile cache.  ``profile_dir`` writes a
``torch.profiler`` trace (``trace.json``) instead of ``jax.profiler``'s.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List

from ..align.aligner import LongReadAligner, align_chunked, resolve_device
from ..align.records import AlignmentSet
from ..config import PipelineConfig
from ..consensus.window import consensus_backbone
from ..graph.pagraph import PAGraph
from ..graph.processor import PositionProcessor
from ..io.fasta import (iter_fasta, write_fasta, write_fasta_if_changed,
                        write_text_if_changed)
from ..io.seqdb import SeqDatabase
from ..ops.kmer import (read_solid_set, solid_set, solid_set_sharded,
                        write_solid_set)
from ..parallel.distributed import (agreed, barrier, gather_alignments,
                                    gather_host_bytes, host_shard_ids,
                                    init_distributed, is_coordinator,
                                    process_count, process_index)
from ..traverse.assembly import assemble_group
from ..traverse.walk import TravelState
from ..utils.timing import rss_mb
from .cache import StageCache
from .preprocess import (group_contigs, group_read_names, read_config,
                         subset_alignments, write_config)


@dataclass
class PipelineResult:
    final_fasta: str
    out_dir: str
    stats: Dict[str, object] = field(default_factory=dict)


def run_pipeline(read_path: str, ctg_path: str, genome_path: str,
                 out_dir: str, cfg: PipelineConfig | None = None,
                 log=print) -> PipelineResult:
    cfg = cfg or PipelineConfig()
    cfg.validate()
    device = resolve_device(cfg.runtime.device)
    if cfg.runtime.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            res = _run(read_path, ctg_path, genome_path, out_dir, cfg, log)
        os.makedirs(cfg.runtime.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.runtime.profile_dir,
                                              "trace.json"))
        return res
    return _run(read_path, ctg_path, genome_path, out_dir, cfg, log)


def _make_mesh(cfg: PipelineConfig):
    """The (data, block) mesh over this process's own devices — every
    local card, or the one CPU device — with its block axis sized by
    cfg.runtime.block_parallel (auto when None).  None when sharding is
    off, which by default it is unless the device is cuda and more than
    one card is present; the aligner then takes host seeding and the
    static band."""
    import torch
    from ..parallel.mesh import make_mesh
    on_card = cfg.runtime.device == "cuda"
    sharded = cfg.runtime.sharded_align
    if sharded is None:
        sharded = on_card and torch.cuda.device_count() > 1
    if not sharded:
        return None
    return make_mesh(block_parallel=cfg.runtime.block_parallel,
                     data_axis=cfg.runtime.data_axis,
                     block_axis=cfg.runtime.block_axis,
                     devices=None if on_card else ["cpu"])


def _run(read_path: str, ctg_path: str, genome_path: str, out_dir: str,
         cfg: PipelineConfig, log) -> PipelineResult:
    t0 = time.time()
    init_distributed()
    mesh = _make_mesh(cfg)
    n_hosts = process_count()
    rank = process_index()
    stats: Dict[str, object] = {}
    stats["sharded_align"] = mesh is not None
    if mesh is not None:
        stats["mesh"] = {n: int(v) for n, v in mesh.shape.items()}
    stats["device"] = cfg.runtime.device
    stage_s: Dict[str, float] = {}
    stage_rss: Dict[str, float] = {}
    _mark_t = [t0]
    # every aligner of the run: under the mesh (which refuses plain), or
    # on the runtime's device with the static band through its plain
    # versions when asked
    dev_kw = (dict(mesh=mesh, plain=cfg.runtime.plain) if mesh is not None
              else dict(device=cfg.runtime.device, plain=cfg.runtime.plain,
                        band="static" if cfg.runtime.plain else None))

    def mark(name: str) -> None:
        """Structured per-stage wall time + RSS at stage end (replaces
        the reference's MyTools prints)."""
        now = time.time()
        stage_s[name] = round(stage_s.get(name, 0.0)
                              + now - _mark_t[0], 3)
        stage_rss[name] = round(rss_mb(), 1)
        _mark_t[0] = now

    wrk = os.path.join(out_dir, "working_dir")
    dirs = {name: os.path.join(wrk, *path.split("/")) for name, path in {
        "mecat_ctg": "mecat/ctg", "mecat_ref": "mecat/ref",
        "mummer": "mummer", "input": "input/p", "pagraph": "pagraph",
        "pagraph_m": "pagraph2", "cns_in": "cns/input",
        "cns_out": "cns/output", "cns_wrk": "cns/wrk",
    }.items()}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    read_path = os.path.realpath(read_path)
    ctg_path = os.path.realpath(ctg_path)
    genome_path = os.path.realpath(genome_path)

    def part_path(d: str) -> str:
        """Intra-stage alignment checkpoint file (align/checkpoint.py);
        rank-suffixed so each process resumes its own shard."""
        suffix = f".r{rank}" if n_hosts > 1 else ""
        return os.path.join(d, "stage.part" + suffix)

    def clear_part(d: str) -> None:
        try:
            os.remove(part_path(d))
        except OSError:
            pass

    def aligner(target_db, aln_cfg, d):
        return LongReadAligner(target_db, aln_cfg,
                               progress=cfg.runtime.progress,
                               checkpoint_path=part_path(d), **dev_kw)

    log("Loading inputs...")
    reads = SeqDatabase.from_file(read_path)
    # each process aligns its share of the reads (all of them when alone)
    read_ids = host_shard_ids(len(reads)) if n_hosts > 1 else None
    ctgs = SeqDatabase.from_file(ctg_path)
    refs = SeqDatabase.from_file(genome_path)
    stats["n_reads"] = len(reads)
    stats["n_contigs"] = len(ctgs)
    stats["n_refs"] = len(refs)

    mark("load")

    # ---- 1. solid k-mer set ----
    log("K-Mer counting...")
    solid_path = os.path.join(wrk, "solid_kmer_set.bin")
    cache = StageCache(wrk)
    if not agreed(cache.check(read_path) and cache.check_args(k=cfg.graph.k)
                  and os.path.exists(solid_path)):
        if n_hosts > 1:
            # each process counts only its read shard; counts merge across
            # processes before the cutoff rule (ops/kmer.py)
            solid = solid_set_sharded(reads, cfg.graph.k,
                                      cfg.graph.solid_threshold,
                                      host_shard_ids(len(reads)),
                                      device=cfg.runtime.device)
        else:
            solid = solid_set(reads, cfg.graph.k, cfg.graph.solid_threshold)
        if is_coordinator():
            write_solid_set(solid_path, cfg.graph.k, solid)
            cache.save(read_path)
            cache.save_args(k=cfg.graph.k)
        barrier("stage1")
        log(f"Done: {len(solid)} solid k-mers")
    else:
        log("Reuse")
    _, solid = read_solid_set(solid_path)
    stats["n_solid"] = len(solid)

    mark("kmer")

    # ---- 2. reads -> contigs ----
    log("Read to Contig...")
    r2c_path = os.path.join(dirs["mecat_ctg"], "read_to_contig.ref")
    c_cache = StageCache(dirs["mecat_ctg"])
    aln_args = dict(alpha=cfg.aligner.alpha, beta=cfg.aligner.beta,
                    delta=cfg.aligner.delta, seed_k=cfg.aligner.seed_k,
                    ref_seed_k=cfg.aligner.ref_seed_k,
                    rescue=cfg.aligner.ref_seed_rescue,
                    prune=cfg.aligner.prune_ratio)
    if not agreed(c_cache.check(read_path, ctg_path)
                  and c_cache.check_args(**aln_args)
                  and os.path.exists(r2c_path)):
        r2c = gather_alignments(aligner(ctgs, cfg.aligner, dirs["mecat_ctg"]
                                        ).align_reads(reads, ids=read_ids))
        if is_coordinator():
            r2c.write_ref(r2c_path)
            c_cache.save(read_path, ctg_path)
            c_cache.save_args(**aln_args)
        clear_part(dirs["mecat_ctg"])
        barrier("stage2")
        log(f"Done: {len(r2c)} alignments")
        # downstream (graph ingest) consumes only the diff masks; drop
        # the gapped strings by reloading mask-only — holding both
        # strings for every alignment dominated RSS at genome scale
        # (the reference streams these from disk per stage,
        # AlignmentHelper.cpp:10-70)
        r2c = AlignmentSet.read_ref(r2c_path, keep_strings=False)
    else:
        r2c = AlignmentSet.read_ref(r2c_path, keep_strings=False)
        log("Reuse")
    stats["n_read_to_ctg"] = len(r2c)

    mark("read_to_ctg")

    # ---- 3. reads -> similar genome ----
    log("Read to Ref...")
    r2r_path = os.path.join(dirs["mecat_ref"], "read_to_ref.ref")
    r_cache = StageCache(dirs["mecat_ref"])
    # the mecat2ref+ role: seed with ref_seed_k (smaller than the
    # same-species stages) so diverged similar-genome regions stay
    # seedable — the product's point (README.md:5)
    ref_aln_cfg = replace(cfg.aligner, seed_k=cfg.aligner.ref_seed_k,
                          seed_k_auto=False)
    if not agreed(r_cache.check(read_path, genome_path)
                  and r_cache.check_args(**aln_args)
                  and os.path.exists(r2r_path)):
        if cfg.aligner.ref_seed_rescue \
                and cfg.aligner.ref_seed_k < cfg.aligner.seed_k:
            # two-level seeding (AlignerConfig.ref_seed_rescue): cheap
            # seed_k pass over everything, ref_seed_k pass over only
            # the reads it left unaligned — the diverged-locus rescue
            p1_cfg = replace(cfg.aligner, seed_k=cfg.aligner.seed_k,
                             seed_k_auto=False)
            r2r = aligner(refs, p1_cfg, dirs["mecat_ref"]
                          ).align_reads(reads, ids=read_ids)
            got = {a.query_name for a in r2r}
            all_ids = read_ids if read_ids is not None else range(len(reads))
            miss = [rid for rid in all_ids if reads.names[rid] not in got]
            log(f"  rescue pass: {len(miss)} unaligned reads at "
                f"k={cfg.aligner.seed_k} -> "
                f"k={cfg.aligner.ref_seed_k}")
            if miss:
                r2r_extra = aligner(refs, ref_aln_cfg, dirs["mecat_ref"]
                                    ).align_reads(reads, ids=miss)
                for a in r2r_extra:
                    r2r.append(a)
                r2r.sort_by_score()
        else:
            r2r = aligner(refs, ref_aln_cfg, dirs["mecat_ref"]
                          ).align_reads(reads, ids=read_ids)
        r2r = gather_alignments(r2r)
        if is_coordinator():
            r2r.write_ref(r2r_path)
            r_cache.save(read_path, genome_path)
            r_cache.save_args(**aln_args)
        clear_part(dirs["mecat_ref"])
        barrier("stage3")
        log(f"Done: {len(r2r)} alignments")
        r2r = AlignmentSet.read_ref(r2r_path, keep_strings=False)
    else:
        r2r = AlignmentSet.read_ref(r2r_path, keep_strings=False)
        log("Reuse")
    stats["n_read_to_ref"] = len(r2r)

    mark("read_to_ref")

    # ---- 4. contigs -> similar genome ----
    log("Contig to Ref...")
    c2r_path = os.path.join(dirs["mummer"], "ctg_to_ref.ref")
    m_cache = StageCache(dirs["mummer"])
    if not agreed(m_cache.check(ctg_path, genome_path)
                  and m_cache.check_args(**aln_args)
                  and os.path.exists(c2r_path)):
        c2r = align_chunked(refs, ctgs, cfg.aligner,
                            progress=cfg.runtime.progress,
                            checkpoint_path=part_path(dirs["mummer"]),
                            **dev_kw)
        if is_coordinator():
            c2r.write_ref(c2r_path)
            m_cache.save(ctg_path, genome_path)
            m_cache.save_args(**aln_args)
        clear_part(dirs["mummer"])
        barrier("stage4")
        log(f"Done: {len(c2r)} alignments")
        c2r = AlignmentSet.read_ref(c2r_path, keep_strings=False)
    else:
        c2r = AlignmentSet.read_ref(c2r_path, keep_strings=False)
        log("Reuse")
    stats["n_ctg_to_ref"] = len(c2r)

    # ---- 5. contig grouping ----
    mark("ctg_to_ref")
    log("Pre process...")
    config_path = os.path.join(dirs["input"], "config.txt")
    p_cache = StageCache(dirs["input"])
    pre_args = dict(top_k=cfg.preprocess.group_top_k,
                    ratio=cfg.preprocess.group_cover_ratio)
    if agreed(p_cache.check(ctg_path, c2r_path)
              and p_cache.check_args(**pre_args)
              and os.path.exists(config_path)):
        groups = read_config(config_path)
        log("Reuse")
    else:
        groups = group_contigs(ctgs, c2r, cfg.preprocess.group_top_k,
                               cfg.preprocess.group_cover_ratio)
        if is_coordinator():
            write_config(config_path, groups)
            p_cache.save(ctg_path, c2r_path)
            p_cache.save_args(**pre_args)
        barrier("stage5")
        log(f"Done: {len(groups)} reference groups")
    stats["n_groups"] = len(groups)

    mark("pre_process")

    # ---- 6. per-group graph + traversal ----
    # Gating mirrors the reference's per-group DONE + ARGS markers on top
    # of the stage-level input CHECK (AlignGraph2.py:405-431): a group is
    # reused iff the stage inputs are unchanged (which includes the
    # aligner-rerun cascade — a recomputed alignment stage rewrites its
    # .ref file, breaking the CHECK) AND its own DONE/ARGS/result are
    # intact.
    log("PAGraph...")
    g_cache = StageCache(dirs["pagraph"])
    stage6_inputs = (read_path, solid_path, r2c_path, r2r_path, c2r_path,
                     config_path)
    stage6_fresh = agreed(g_cache.check(*stage6_inputs))
    if not stage6_fresh and is_coordinator():
        # Inputs changed: every surviving per-group DONE marker refers to
        # OLD-input results.  Clear them BEFORE recording the new input
        # state — otherwise a crash mid-stage leaves the new CHECK on
        # disk and the next run (seeing stage6_fresh=True) would silently
        # reuse stale group results.
        for stale in sorted(glob.glob(
                os.path.join(dirs["pagraph"], "*", "DONE"))):
            os.remove(stale)
        # record input state up front: a crashed run resumes per-group via
        # the DONE markers, exactly like the reference's per-group gating
        g_cache.save(*stage6_inputs)
    g_args = dict(k=cfg.graph.k, epsilon=cfg.graph.epsilon,
                  min_len=cfg.graph.min_len, cov=cfg.graph.cov_filter,
                  outer_sample=cfg.graph.outer_sample,
                  error_rate=cfg.graph.error_rate,
                  start_split=cfg.graph.start_split,
                  travel_top_k=cfg.graph.travel_top_k,
                  r2c_ratio=cfg.graph.read_to_ctg_ratio,
                  r2r_ratio=cfg.graph.read_to_ref_ratio)
    graph = None
    all_success: set = set()
    connections: List[dict] = []
    reused_groups = 0
    local_results: Dict[int, dict] = {}   # gi -> payload (this process)
    for gi, group in enumerate(groups):
        if n_hosts > 1 and gi % n_hosts != rank:
            continue  # another process owns this group (gathered below)
        gdir = os.path.join(dirs["pagraph"], str(gi))
        os.makedirs(gdir, exist_ok=True)
        res_path = os.path.join(gdir, "result.json")
        grp_cache = StageCache(gdir)
        if (stage6_fresh and grp_cache.check_args(**g_args)
                and os.path.exists(os.path.join(gdir, "DONE"))
                and os.path.exists(res_path)):
            with open(res_path) as f:
                payload = json.load(f)
            log(f"  group {gi}: Reuse")
            reused_groups += 1
        else:
            log(f"  group {gi}: ref={group.ref_name} "
                f"contigs={len(group.contigs)}")
            if graph is None:
                graph = PAGraph(solid, cfg.graph.k,
                                device=cfg.runtime.device)
            member_names = {n for n, _ in group.contigs}
            g_ctgs = ctgs.subset_by_names(member_names)
            g_refs = refs.subset_by_names({group.ref_name})
            read_names = group_read_names(
                group, subset_alignments(r2c, None, member_names),
                subset_alignments(r2r, None, {group.ref_name}))
            g_reads = reads.subset_by_names(read_names)
            g_r2c = subset_alignments(r2c, read_names, member_names)
            g_r2r = subset_alignments(r2r, read_names, {group.ref_name})
            g_c2r = subset_alignments(c2r, member_names, {group.ref_name})

            graph.reset()
            pp = PositionProcessor(graph, g_reads, g_ctgs, g_refs, g_r2c,
                                   g_r2r, g_c2r, group, cfg.graph)
            pp.pre_process()
            pp.process(log=log, threads=cfg.runtime.threads)
            st = TravelState(
                graph=graph, ctgs=g_ctgs, refs=g_refs,
                ctg_mapper=pp.ctg_mapper, ref_mapper=pp.ref_mapper,
                deviation=cfg.graph.epsilon * 2,
                error_rate=cfg.graph.error_rate,
                start_split=cfg.graph.start_split,
                min_len=cfg.graph.min_len, top_k=cfg.graph.travel_top_k,
                threads=cfg.runtime.threads)
            res = assemble_group(st, group.contigs, gdir, f"{gi}_")
            payload = {"success": sorted(res.success),
                       "connections": res.connections}
            with open(res_path, "w") as f:
                json.dump(payload, f)
            grp_cache.save_args(**g_args)
            with open(os.path.join(gdir, "DONE"), "w"):
                pass
        local_results[gi] = payload
    # merge per-group results across processes (group order)
    if n_hosts > 1:
        for blob in gather_host_bytes(json.dumps(local_results).encode()):
            local_results.update({int(k): v
                                  for k, v in json.loads(blob).items()})
    for gi in sorted(local_results):
        payload = local_results[gi]
        all_success |= {(n, bool(fwd)) for n, fwd in payload["success"]}
        for c in payload["connections"]:
            c["members"] = [(n, bool(fw), ln) for n, fw, ln in c["members"]]
            connections.append(c)
    log(f"Done: {len(connections)} assembled chains, "
        f"{len(all_success)} contigs consumed"
        + (f" ({reused_groups} groups reused)" if reused_groups else ""))
    stats["n_chains"] = len(connections)
    stats["consumed"] = sorted(n for n, _ in all_success)
    stats["reused_groups"] = reused_groups

    # merged outputs (split_helper.merge_out semantics); content-addressed
    # writes keep mtimes stable so downstream CHECKs survive no-op reruns
    contig_txt = os.path.join(dirs["pagraph_m"], "contig.txt")
    coninfo = os.path.join(dirs["pagraph_m"], "coninfo")
    coninfo_lines = []
    for c in connections:
        coninfo_lines.append(f"{c['name']}\t{c['length']}\n")
        for cname, cfwd, clen in c["members"]:
            coninfo_lines.append(
                f"{cname}\t{'FORWARD' if cfwd else 'REV'}\t{clen}\n")
        coninfo_lines.append("\n")
    if is_coordinator():
        write_text_if_changed(
            contig_txt,
            "".join(name + "\n"
                    for name in sorted({n for n, _ in all_success})))
        write_text_if_changed(coninfo, "".join(coninfo_lines))

    mark("pagraph")

    # ---- 7. extract + align reads to new contigs ----
    log("Extract and split...")
    consumed = {n for n, _ in all_success}
    include = [(n, s) for n, s in ctgs.records() if n not in consumed]
    exclude = [(n, s) for n, s in ctgs.records() if n in consumed]
    add = [(c["name"], c["sequence"]) for c in connections]
    cns_in = dirs["cns_in"]
    all_path = os.path.join(cns_in, "all.fasta")
    if is_coordinator():
        write_fasta_if_changed(os.path.join(cns_in, "include.fasta"),
                               include)
        write_fasta_if_changed(os.path.join(cns_in, "exclude.fasta"),
                               exclude)
        write_fasta_if_changed(os.path.join(cns_in, "add.fasta"), add)
        write_fasta_if_changed(all_path, include + add)
    # stage 7's cache reads all.fasta on every process
    barrier("extract")

    mark("extract")
    log("Align and split...")
    merge_path = os.path.join(dirs["cns_wrk"], "merge.ref")
    w_cache = StageCache(dirs["cns_wrk"])
    if add:
        if agreed(w_cache.check(read_path, all_path)
                  and w_cache.check_args(**aln_args)
                  and os.path.exists(merge_path)):
            merge_alns = AlignmentSet.read_ref(merge_path)
            log("Reuse")
        else:
            # the new backbones are targets: only the reads' lengths
            # route a batch to the static band
            all_db = SeqDatabase(include + add)
            merge_alns = gather_alignments(
                aligner(all_db, cfg.aligner, dirs["cns_wrk"]
                        ).align_reads(reads, ids=read_ids))
            if is_coordinator():
                merge_alns.write_ref(merge_path)
                w_cache.save(read_path, all_path)
                w_cache.save_args(**aln_args)
            clear_part(dirs["cns_wrk"])
            barrier("stage7")
            log(f"Done: {len(merge_alns)} alignments")

    # ---- 8. windowed consensus ----
    mark("align_split")
    log("Correct...")
    cor_path = os.path.join(dirs["cns_out"], "cor.fasta")
    o_cache = StageCache(dirs["cns_out"])
    cns_args = dict(window=cfg.consensus.window, top_k=cfg.consensus.top_k,
                    alpha=cfg.consensus.alpha,
                    min_weight=cfg.consensus.min_weight)
    cor_records = []
    if add:
        if agreed(o_cache.check(merge_path, all_path)
                  and o_cache.check_args(**cns_args)
                  and os.path.exists(cor_path)):
            cor_records = list(iter_fasta(cor_path))
            log("Reuse")
        else:
            per_backbone: Dict[str, AlignmentSet] = {
                name: AlignmentSet() for name, _ in add}
            for a in merge_alns:
                if a.ref_name in per_backbone:
                    per_backbone[a.ref_name].append(a)
            local_cor: Dict[int, list] = {}
            for bi, (name, seq) in enumerate(add):
                if n_hosts > 1 and bi % n_hosts != rank:
                    continue  # another process corrects this backbone
                log(f"\tcorrecting {name}")
                cns = consensus_backbone(seq, per_backbone[name],
                                         cfg.consensus,
                                         threads=cfg.runtime.threads,
                                         device=cfg.runtime.device)
                local_cor[bi] = [name, cns if cns else seq]
            if n_hosts > 1:
                for blob in gather_host_bytes(
                        json.dumps(local_cor).encode()):
                    local_cor.update({int(k): v for k, v
                                      in json.loads(blob).items()})
            cor_records = [tuple(local_cor[bi]) for bi in sorted(local_cor)]
            if is_coordinator():
                write_fasta(cor_path, cor_records)
                o_cache.save(merge_path, all_path)
                o_cache.save_args(**cns_args)
            barrier("stage8")
    elif is_coordinator():
        write_fasta(cor_path, cor_records)
    mark("correct")

    # ---- final outputs ----
    final_path = os.path.join(out_dir, "final.fasta")
    if is_coordinator():
        write_fasta(final_path, include + cor_records)
        write_fasta(os.path.join(out_dir, "remainder.fasta"), include)
        write_fasta(os.path.join(out_dir, "exclude.fasta"), exclude)
        write_fasta(os.path.join(out_dir, "add.fasta"), cor_records)
        shutil.copyfile(coninfo, os.path.join(out_dir, "connect_info.txt"))
    barrier("final")

    mark("emit")
    stats["wall_s"] = time.time() - t0
    stats["stage_s"] = stage_s
    stats["stage_rss_mb"] = stage_rss
    stats["rss_mb"] = rss_mb()
    if is_coordinator():
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(stats, f, indent=1, default=str)
    log(f"Final output: {final_path}")
    log(f"Time used: {stats['wall_s']:.3f} seconds")
    return PipelineResult(final_fasta=final_path, out_dir=out_dir,
                          stats=stats)
