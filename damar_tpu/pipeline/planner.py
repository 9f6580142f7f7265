"""Pipeline planning and idempotent execution (L8, SURVEY.md §2.9:
HPC.daligner-style job matrices; the reference's entire distributed
story is independent jobs + file rendezvous).

The equivalents here:
  * plan_block_pairs: the N*(N+1)/2 block-pair matrix with per-pair
    .las outputs and merge steps — as a data structure, not a shell
    script (but render_script emits the shell form for parity).
  * Manifest: done-marker bookkeeping so a restarted run resumes
    exactly where it stopped (SURVEY.md §5.3: every stage idempotent,
    file-checkpointed).
  * run_overlap_plan: executes the matrix locally (single host,
    sequential over pairs, device-parallel within a pair), writing
    per-pair sorted .las + done markers, then merging per A-block.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Job:
    name: str
    kind: str              # "overlap" | "merge" | "check"
    args: dict
    deps: list[str] = field(default_factory=list)


def plan_block_pairs(db_root: str, nblocks: int,
                     las_dir: str = ".") -> list[Job]:
    """The block-pair job matrix + per-A-block merge tree."""
    jobs: list[Job] = []
    for i in range(1, nblocks + 1):
        pair_outputs = []
        for j in range(1, nblocks + 1):
            if j < i:
                continue  # pair (j, i) covers it symmetrically
            name = f"overlap.{i}.{j}"
            jobs.append(Job(
                name=name, kind="overlap",
                args=dict(db=db_root, a_block=i, b_block=j,
                          out_a=os.path.join(
                              las_dir, f"{db_root}.{i}.{db_root}.{j}.las"),
                          out_b=os.path.join(
                              las_dir, f"{db_root}.{j}.{db_root}.{i}.las")),
            ))
        ins = [os.path.join(las_dir, f"{db_root}.{i}.{db_root}.{j}.las")
               for j in range(1, nblocks + 1)]
        jobs.append(Job(
            name=f"merge.{i}", kind="merge",
            args=dict(inputs=ins,
                      out=os.path.join(las_dir, f"{db_root}.{i}.las")),
            deps=[f"overlap.{min(i, j)}.{max(i, j)}"
                  for j in range(1, nblocks + 1)],
        ))
        jobs.append(Job(
            name=f"check.{i}", kind="check",
            args=dict(las=os.path.join(las_dir, f"{db_root}.{i}.las"),
                      db=db_root),
            deps=[f"merge.{i}"],
        ))
    return jobs


def plan_masking(db_root: str, nblocks: int,
                 rep_rounds: tuple = None) -> list[Job]:
    """The HPC.TANmask / HPC.REPmask-equivalent job list: dust +
    per-block tandem masking (independent block jobs + a track merge),
    then COARSE-TO-FINE repeat-mask rounds (upstream HPC.REPmask plans
    3 rounds of group-limited daligner sweeps with falling coverage
    thresholds — each round's track soft-masks the next round's
    seeding, so high-copy repeats are suppressed before they flood the
    finer rounds' hit buffers).

    rep_rounds: tuple of (group_size, cov_multiple) per round; group
    size g means each block is overlapped against g blocks starting at
    itself (g=0 -> all blocks).  Defaults to the reference's 3-round
    shape scaled to the block count."""
    if rep_rounds is None:
        if nblocks <= 1:
            rep_rounds = ((0, 2.0),)
        elif nblocks <= 4:
            rep_rounds = ((1, 4.0), (0, 2.0))
        else:
            rep_rounds = ((1, 4.0), (min(4, nblocks), 3.0), (0, 2.0))
    jobs: list[Job] = []
    jobs.append(Job(name="dust", kind="mask",
                    args=dict(cmd="dbdust", db=db_root)))
    for i in range(1, nblocks + 1):
        jobs.append(Job(name=f"tan.{i}", kind="mask",
                        args=dict(cmd="datander", db=db_root, block=i)))
    jobs.append(Job(name="tan.merge", kind="mask",
                    args=dict(cmd="tkmerge", db=db_root, track="tan"),
                    deps=[f"tan.{i}" for i in range(1, nblocks + 1)]))
    masks = ["dust", "tan"]
    for r, (g, cmult) in enumerate(rep_rounds, 1):
        track = f"rep{r}" if len(rep_rounds) > 1 else "rep"
        grp = nblocks if g == 0 else min(g, nblocks)
        for i in range(1, nblocks + 1):
            pair_deps = []
            for dj in range(grp):
                j = (i - 1 + dj) % nblocks + 1
                a, b = min(i, j), max(i, j)
                name = f"rep{r}.ovl.{a}.{b}"
                if not any(jb.name == name for jb in jobs):
                    jobs.append(Job(
                        name=name, kind="overlap",
                        args=dict(db=db_root, a_block=a, b_block=b,
                                  masks=list(masks),
                                  out_a=f"{db_root}.R{r}.{a}.{b}.las",
                                  out_b=f"{db_root}.R{r}.{b}.{a}.las"),
                        deps=(["tan.merge"] if r == 1
                              else [f"rep{r-1}.merge"])))
                pair_deps.append(name)
            jobs.append(Job(
                name=f"rep{r}.{i}", kind="mask",
                args=dict(cmd="repmask", db=db_root, block=i,
                          cov_mult=cmult, track=track,
                          las=f"{db_root}.R{r}.{i}.las"),
                deps=pair_deps))
        jobs.append(Job(
            name=f"rep{r}.merge", kind="mask",
            args=dict(cmd="tkmerge", db=db_root, track=track),
            deps=[f"rep{r}.{i}" for i in range(1, nblocks + 1)]))
        masks = masks + [track]
    return jobs


def render_script(jobs: list[Job], db_root: str | None = None,
                  with_masking: bool = True, nblocks: int | None = None
                  ) -> str:
    """HPC.daligner-parity rendering: one shell line per job, phase
    comments, using this package's CLI.  with_masking prepends the
    HPC.TANmask/HPC.REPmask-equivalent phase lines (dust + per-block
    tandem detection, then repeat masking fed back into the job
    matrix)."""
    lines = ["# damar_tpu job plan"]
    # generated job scripts run from arbitrary workdirs (the shared-FS
    # rendezvous contract): make the package importable even from a
    # non-installed checkout.  HPC planner output is machine-local by
    # nature, exactly like the reference's generated scripts.
    import damar_tpu
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(damar_tpu.__file__)))
    lines.append(f'export PYTHONPATH="{pkg_parent}:$PYTHONPATH"')
    if with_masking and db_root:
        nb = nblocks or max(
            (j.args.get("a_block", 1) for j in jobs
             if j.kind == "overlap"), default=1)
        lines.append("# phase 0: masking "
                     "(HPC.TANmask / HPC.REPmask equivalents)")
        for j in plan_masking(db_root, nb):
            a = j.args
            if j.kind == "overlap":
                m = " ".join(f"-m {t}" for t in a.get("masks", []))
                lines.append(
                    f"python -m damar_tpu.cli daligner {a['db']} "
                    f"{a['a_block']} {a['b_block']}"
                    + (f"  # masks: {m}" if m else ""))
                continue
            if a["cmd"] == "dbdust":
                lines.append(f"python -m damar_tpu.cli dbdust {db_root}")
            elif a["cmd"] == "datander":
                lines.append(f"python -m damar_tpu.cli datander "
                             f"{db_root} -b {a['block']}")
            elif a["cmd"] == "tkmerge":
                lines.append(f"python -m damar_tpu.cli tkmerge "
                             f"{db_root} {a['track']}")
            elif a["cmd"] == "repmask":
                lines.append(f"# after {', '.join(j.deps[:1])}: "
                             f"python -m damar_tpu.cli repmask "
                             f"{db_root} {a['las']}")
    lines += ["# phase 1: block-pair overlaps"]
    for j in jobs:
        if j.kind == "overlap":
            a = j.args
            lines.append(
                f"python -m damar_tpu.cli daligner {a['db']} "
                f"{a['a_block']} {a['b_block']}")
    lines.append("# phase 2: merges")
    for j in jobs:
        if j.kind == "merge":
            a = j.args
            lines.append(
                "python -m damar_tpu.cli lamerge " + a["out"] + " "
                + " ".join(a["inputs"]))
    lines.append("# phase 3: checks")
    for j in jobs:
        if j.kind == "check":
            a = j.args
            lines.append(f"python -m damar_tpu.cli lacheck {a['db']} "
                         f"{a['las']}")
    return "\n".join(lines) + "\n"


class Manifest:
    """Done-marker bookkeeping in a JSONL file: each completed job
    appends one record; a restarted run skips completed jobs."""

    def __init__(self, path: str):
        self.path = path
        self.done: dict[str, dict] = {}
        self.reload()

    def reload(self) -> None:
        """Re-read the JSONL from disk: on a shared filesystem other
        hosts' appended done-markers become visible (the multi-host
        rendezvous).  Unparseable lines (torn multi-writer appends on
        non-POSIX filesystems) are skipped, not fatal — a lost marker
        only means the idempotent job reruns."""
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    self.done[rec["name"]] = rec

    def is_done(self, name: str) -> bool:
        return name in self.done

    def mark(self, name: str, **info) -> None:
        rec = {"name": name, **info}
        self.done[name] = rec
        # one O_APPEND write syscall per record: atomic on POSIX local
        # filesystems, so concurrent hosts' lines don't interleave
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                     0o644)
        try:
            os.write(fd, (json.dumps(rec) + "\n").encode())
        finally:
            os.close(fd)

    def claim(self, name: str, stale_s: float = 3600.0) -> bool:
        """Exclusive claim of a job across hosts via an O_EXCL lock
        file next to the manifest.  Returns True when THIS process owns
        the job.  A lock older than stale_s (a host died mid-job) is
        broken and re-claimed."""
        import time
        lock = f"{self.path}.{name}.lock"
        for _ in range(2):
            try:
                fd = os.open(lock, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                             0o644)
                os.write(fd, f"{os.getpid()} {time.time()}\n".encode())
                os.close(fd)
                return True
            except FileExistsError:
                try:
                    age = time.time() - os.path.getmtime(lock)
                except OSError:
                    continue     # lock vanished: retry the claim
                if age <= stale_s:
                    return False
                try:
                    os.remove(lock)      # stale: break and retry
                except OSError:
                    return False
        return False


def run_overlap_plan(db_path: str, cfg, las_dir: str = None,
                     manifest_path: str = None, verbose: bool = True,
                     mask_names: list[str] | None = None,
                     nhosts: int = 1, host_id: int = 0) -> dict:
    """Execute the overlap job matrix for a split DB, idempotently.

    Returns stats.  Each pair runs the device pipeline via
    overlap_block_pair (device-parallel within the pair).  With
    nhosts > 1, this host processes only its round-robin slice of the
    pair matrix (parallel/distributed.host_pair_slice) — launch one
    process per host a la SLURM array, sharing the filesystem; the
    per-A-block merge runs once every pair of that block is marked
    done in the shared manifest (any host may perform it).
    """
    import time
    from damar_tpu.core.blocks import block_from_db
    from damar_tpu.formats import dazzdb, las as lasmod, tracks
    from damar_tpu.ops.kmers import mask_vector_from_track
    from damar_tpu.pipeline.overlap import overlap_block_pair  # noqa: F401 (API re-export for callers)

    db = dazzdb.DazzDB.open(db_path)
    d, root = os.path.split(dazzdb.stub_path(db_path))
    root = root[:-3]
    las_dir = las_dir or d
    manifest = Manifest(manifest_path or
                        os.path.join(las_dir, f".{root}.overlap.manifest"))
    n = max(db.nblocks, 1)
    stats = {"pairs": 0, "skipped": 0, "overlaps": 0}
    blocks = {}
    masks = {}

    def get_block(i):
        if i not in blocks:
            blocks[i] = block_from_db(db, i)
            if mask_names:
                ivs = None
                blk = blocks[i]
                per_read = [np.zeros(0, np.int32)] * blk.nreads
                for name in mask_names:
                    if not tracks.track_exists(db_path, name):
                        continue
                    t = tracks.read_track(db_path, name)
                    for j, rid in enumerate(blk.ids):
                        from damar_tpu.formats.tracks import \
                            merge_interval_lists
                        per_read[j] = merge_interval_lists(
                            per_read[j], t.data[int(rid)])
                masks[i] = mask_vector_from_track(
                    per_read, blk.starts, blk.cap)
        return blocks[i], masks.get(i)

    from damar_tpu.parallel.distributed import host_pair_slice
    from damar_tpu.pipeline.overlap import release_device_buffers
    pairs = host_pair_slice(n, nhosts, host_id)
    size_hints: dict = {}
    prev_a = None
    # bound device-buffer residency: uploads (bases/read_id/packed
    # words/rc) pin ~6.5 bytes of HBM per base per block — an LRU over
    # B blocks keeps at most max_resident blocks' buffers alive
    # (round-3 advisor; the A block is pinned separately for its row)
    max_resident = int(os.environ.get("DAMAR_RESIDENT_BLOCKS", "8"))
    lru: list[int] = []

    def touch(idx: int, a_block: int):
        if idx in lru:
            lru.remove(idx)
        lru.append(idx)
        while len(lru) > max_resident:
            # oldest entry that is not the active A row
            for q, victim in enumerate(lru):
                if victim != a_block:
                    lru.pop(q)
                    if victim in blocks:
                        release_device_buffers(blocks[victim])
                    break
            else:
                break

    from damar_tpu.pipeline.overlap import overlap_pairs_pipelined

    def job_iter():
        nonlocal prev_a
        for i, j in pairs:
            # the A-side index memo (overlap._cached_a_index) lives for
            # the block's whole B row; drop it when the row advances so
            # at most one block's index stays resident
            if prev_a is not None and prev_a != i and prev_a in blocks:
                blocks[prev_a].cache.clear()
            prev_a = i
            name = f"overlap.{i}.{j}"
            out_a = os.path.join(las_dir, f"{root}.{i}.{root}.{j}.las")
            out_b = os.path.join(las_dir, f"{root}.{j}.{root}.{i}.las")
            if manifest.is_done(name) and os.path.exists(out_a):
                stats["skipped"] += 1
                continue
            blk_a, mask_a = get_block(i)
            blk_b, mask_b = get_block(j)
            touch(i, i)
            touch(j, i)
            yield dict(tag=(i, j, name, out_a, out_b, time.time()),
                       blk_a=blk_a, blk_b=blk_b, self_block=(i == j),
                       mask_a=mask_a, mask_b=mask_b,
                       size_hints=size_hints)

    # pipelined sweep: on a device backend, pair N's trace + .las
    # encode runs on host cores (bit-identical C kernels) while the
    # device seeds/extends pair N+1; on the CPU backend this degrades to
    # the plain sequential loop
    for tag, la, lb, st in overlap_pairs_pipelined(job_iter(), cfg):
        i, j, name, out_a, out_b, t0 = tag
        lasmod.write_las(out_a, la)
        if i != j:
            lasmod.write_las(out_b, lb)
        else:
            # self pair: mirrors belong to the same block pile set
            both = lasmod.LasFile.concat([la, lb])
            both.sort()
            lasmod.write_las(out_a, both)
        manifest.mark(name, novl=la.novl, wall=round(time.time() - t0, 2))
        stats["pairs"] += 1
        stats["overlaps"] += la.novl
        for k in ("trace_retries", "trace_retries_wide", "dropped_trace"):
            stats[k] = stats.get(k, 0) + st.get(k, 0)
        if verbose:
            print(f"# {name}: {la.novl} overlaps "
                  f"({time.time() - t0:.1f}s) {st}")
    # merge per A-block — only once EVERY pair touching the block is
    # done (multi-host runs reach this point per host; the manifest on
    # the shared filesystem is the rendezvous, like the reference)
    manifest.reload()
    for i in range(1, n + 1):
        name = f"merge.{i}"
        out = os.path.join(las_dir, f"{root}.{i}.las")
        if manifest.is_done(name) and os.path.exists(out):
            continue
        ready = all(
            manifest.is_done(f"overlap.{min(i, j)}.{max(i, j)}")
            for j in range(1, n + 1))
        if not ready:
            stats.setdefault("merges_deferred", 0)
            stats["merges_deferred"] += 1
            continue
        # exclusive cross-host claim + write-to-tmp + atomic rename:
        # several hosts can reach readiness simultaneously
        if not manifest.claim(name):
            continue
        ins = []
        for j in range(1, n + 1):
            p = os.path.join(las_dir, f"{root}.{i}.{root}.{j}.las")
            if os.path.exists(p):
                ins.append(p)
        if ins:
            tmp = f"{out}.tmp.{os.getpid()}"
            lasmod.merge_las(ins, tmp)
            os.replace(tmp, out)
            manifest.mark(name, inputs=len(ins))
    return stats
