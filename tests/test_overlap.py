"""End-to-end overlap detection test (BASELINE config 1 equivalent:
single-block self-comparison on simulated reads with ground truth)."""
import numpy as np
import pytest

from damar_tpu.core.blocks import block_from_reads
from damar_tpu.core.config import OverlapConfig
from damar_tpu.formats.las import check_las, merge_las, cat_las, LasFile, write_las, read_las
from damar_tpu.formats.oflags import OVL_COMP
from damar_tpu.pipeline.overlap import overlap_block_pair

CFG = OverlapConfig(seed_batch=512)


@pytest.fixture(scope="module")
def overlap_result(small_sim):
    blk = block_from_reads(small_sim.reads)
    las_a, las_b, stats = overlap_block_pair(
        blk, blk, CFG, self_block=True,
        hit_cap=1 << 20, seed_cap=1 << 15)
    return small_sim, blk, las_a, las_b, stats


class TestOverlapE2E:
    def test_las_structurally_clean(self, overlap_result):
        sim, blk, las_a, las_b, stats = overlap_result
        rlen = np.array([len(r) for r in sim.reads])
        assert las_a.novl > 0
        errs = check_las(las_a, rlen)
        assert errs == [], errs[:5]
        errs_b = check_las(las_b, rlen)
        assert errs_b == [], errs_b[:5]

    def test_recall_and_precision(self, overlap_result):
        sim, blk, las_a, las_b, stats = overlap_result
        found = {(o.aread, o.bread, bool(o.flags & OVL_COMP))
                 for o in las_a.overlaps}
        n = len(sim.reads)
        n_true = n_found = 0
        for a in range(n):
            for b in range(a + 1, n):
                if sim.true_overlap(a, b, 1500):
                    comp = sim.strand[a] != sim.strand[b]
                    n_true += 1
                    if (a, b, comp) in found:
                        n_found += 1
        recall = n_found / max(n_true, 1)
        assert recall >= 0.9, f"recall {recall:.3f} ({n_found}/{n_true})"
        # precision: every reported overlap >= min_len must be true
        n_bad = sum(
            1 for (a, b, c) in found
            if not sim.true_overlap(a, b, 300))
        assert n_bad / max(len(found), 1) <= 0.05, \
            f"{n_bad}/{len(found)} spurious overlaps"

    def test_mirror_symmetry(self, overlap_result):
        sim, blk, las_a, las_b, stats = overlap_result
        # every (a,b) record has a (b,a) mirror with reflected coords
        prim = {}
        for o in las_a.overlaps:
            prim[(o.aread, o.bread, o.flags & OVL_COMP,
                  o.abpos, o.aepos)] = o
        rlen = np.array([len(r) for r in sim.reads])
        n_checked = 0
        for m in las_b.overlaps:
            comp = m.flags & OVL_COMP
            if comp:
                bl = rlen[m.aread]
                al = rlen[m.bread]
                key = (m.bread, m.aread, comp,
                       al - m.bepos, al - m.bbpos)
            else:
                key = (m.bread, m.aread, comp, m.bbpos, m.bepos)
            if key in prim:
                n_checked += 1
        # symmetry is an INVARIANT (reference parity): every record
        # has its mirror — trace-retry drops are symmetric by uid
        assert las_a.novl == las_b.novl
        assert n_checked == las_b.novl, \
            f"{n_checked}/{las_b.novl} mirrored"

    def test_diff_rates_sane(self, overlap_result):
        sim, blk, las_a, las_b, stats = overlap_result
        rates = [o.diffs / max(o.aepos - o.abpos, 1)
                 for o in las_a.overlaps]
        med = float(np.median(rates))
        # 14% per-read error -> ~25% pair rate
        assert 0.15 < med < 0.35, med

    def test_roundtrip_through_disk(self, overlap_result, tmp_path):
        sim, blk, las_a, las_b, stats = overlap_result
        p1 = str(tmp_path / "a.las")
        p2 = str(tmp_path / "b.las")
        pm = str(tmp_path / "m.las")
        write_las(p1, las_a)
        write_las(p2, las_b)
        merge_las([p1, p2], pm)
        m = read_las(pm)
        assert m.novl == las_a.novl + las_b.novl
        rlen = np.array([len(r) for r in sim.reads])
        assert check_las(m, rlen) == []


class TestIdentityOption:
    def test_identity_reports_self_overlaps(self):
        """OverlapConfig.identity (daligner -I): tandem-bearing reads
        gain aread==bread records; default drops them."""
        import numpy as np
        from damar_tpu.utils.sim import make_genome, mutate
        rng = np.random.default_rng(3)
        unit = rng.integers(0, 4, 900).astype(np.uint8)
        tandem = np.concatenate([mutate(unit, 0.05, rng)
                                 for _ in range(3)])  # 3 copies
        other = [rng.integers(0, 4, 2000).astype(np.uint8)
                 for _ in range(3)]
        reads = [tandem] + other
        blk = block_from_reads(reads)
        for ident, expect_self in ((False, False), (True, True)):
            cfg = OverlapConfig(min_len=500, identity=ident,
                                seed_batch=128)
            la, lb, _ = overlap_block_pair(
                blk, blk, cfg, self_block=True,
                hit_cap=1 << 18, seed_cap=1 << 12)
            h = la.columns.headers if la.columns is not None else None
            selfs = (int((h[:, 7] == h[:, 8]).sum())
                     if h is not None and len(h) else 0)
            if expect_self:
                assert selfs > 0, "identity=True found no self-overlaps"
            else:
                assert selfs == 0, f"{selfs} self records at default"


class TestBiasedComposition:
    """daligner -b: information-weighted band coverage (VERDICT r1
    item 9).  On an AT-rich genome, AT-dominated k-mer clusters must
    clear a higher bar, suppressing composition-driven seeds without
    losing true overlaps."""

    def _at_rich_sim(self):
        rng = np.random.default_rng(91)
        g = rng.choice(np.arange(4, dtype=np.uint8), size=60_000,
                       p=[0.40, 0.10, 0.10, 0.40])
        from damar_tpu.utils.sim import SimReads, mutate
        from damar_tpu.formats.fasta import revcomp
        reads, starts, ends, strands = [], [], [], []
        for _ in range(140):
            L = int(rng.integers(2500, 5000))
            s = int(rng.integers(0, len(g) - L))
            span = g[s:s + L]
            d = int(rng.integers(0, 2))
            r = span if d == 0 else revcomp(span)
            reads.append(mutate(r, 0.13, rng))
            starts.append(s); ends.append(s + L); strands.append(d)
        return SimReads(genome=g, reads=reads,
                        start=np.array(starts), end=np.array(ends),
                        strand=np.array(strands), err=0.13), g

    def test_host_device_parity_and_recall(self):
        import os
        from damar_tpu.ops.seeding import bias_weight_lut
        from damar_tpu.ops import seeding_host as sh
        from damar_tpu.ops.seeding import find_seeds_canonical_dev
        from damar_tpu.pipeline.overlap import fetch_seeds
        sim, g = self._at_rich_sim()
        blk = block_from_reads(sim.reads)
        cfg = OverlapConfig(seed_batch=512, bias=True)
        lut = bias_weight_lut(blk.bases)
        assert lut[0] > 256 * 0.5 and lut[1] > lut[0], \
            "rare bases must weigh more"
        sd = fetch_seeds(find_seeds_canonical_dev(
            blk, blk, cfg, upper_only=True, self_pair=True,
            hit_cap=1 << 20, seed_cap=1 << 15, bias_lut=lut))
        sh_ = sh.fetch_seeds_host(sh.find_seeds_canonical_host(
            blk, blk, cfg, upper_only=True, self_pair=True,
            hit_cap=1 << 20, seed_cap=1 << 15, bias_lut=lut))
        assert sd["nseeds"] == sh_["nseeds"]
        for k in ("aread", "bread", "apos", "bpos", "comp"):
            np.testing.assert_array_equal(sd[k], sh_[k], err_msg=k)

    def test_bias_suppresses_at_seeds_keeps_overlaps(self):
        sim, g = self._at_rich_sim()
        blk = block_from_reads(sim.reads)
        results = {}
        for bias in (False, True):
            cfg = OverlapConfig(seed_batch=512, bias=bias)
            la, lb, st = overlap_block_pair(
                blk, blk, cfg, self_block=True,
                hit_cap=1 << 20, seed_cap=1 << 15)
            found = {(o.aread, o.bread) for o in la.overlaps}
            results[bias] = (st["seeds"], found)
        s0, f0 = results[False]
        s1, f1 = results[True]
        assert s1 < s0, f"bias did not reduce seeds ({s1} vs {s0})"
        # true overlaps survive: pairs found without bias and truly
        # overlapping must still be found
        true0 = {p for p in f0 if sim.true_overlap(*p, 1500)}
        true1 = {p for p in f1 if sim.true_overlap(*p, 1500)}
        assert len(true1) >= 0.97 * len(true0), \
            f"bias lost true overlaps: {len(true1)}/{len(true0)}"


class TestPipelinedSweep:
    def test_host_trace_emit_matches_device_path(self, small_sim,
                                                 tmp_path):
        # overlap_pair_emit(trace_host=True) must produce byte-equal
        # .las to the default path (the C trace kernels are
        # bit-identical replicas) — the pipelined sweep depends on it
        from damar_tpu import native
        if not native.available():
            pytest.skip("native library unavailable")
        from damar_tpu.pipeline.overlap import (overlap_pair_device,
                                                overlap_pair_emit)
        blk = block_from_reads(small_sim.reads)
        ref_a, ref_b, _ = overlap_block_pair(
            blk, blk, CFG, self_block=True,
            hit_cap=1 << 20, seed_cap=1 << 15)
        state = overlap_pair_device(blk, blk, CFG, self_block=True,
                                    hit_cap=1 << 20, seed_cap=1 << 15)
        las_a, las_b, _ = overlap_pair_emit(state, trace_host=True)
        pa, pb = tmp_path / "a.las", tmp_path / "b.las"
        ra, rb = tmp_path / "ra.las", tmp_path / "rb.las"
        write_las(str(pa), las_a)
        write_las(str(pb), las_b)
        write_las(str(ra), ref_a)
        write_las(str(rb), ref_b)
        assert pa.read_bytes() == ra.read_bytes()
        assert pb.read_bytes() == rb.read_bytes()

    def test_pipelined_generator_matches_sequential(self, small_sim,
                                                    tmp_path):
        from damar_tpu.pipeline.overlap import overlap_pairs_pipelined
        blk = block_from_reads(small_sim.reads)
        jobs = [dict(tag=k, blk_a=blk, blk_b=blk, self_block=True,
                     hit_cap=1 << 20, seed_cap=1 << 15)
                for k in range(2)]
        outs = list(overlap_pairs_pipelined(jobs, CFG))
        assert [t for t, *_ in outs] == [0, 1]
        ref_a, _, _ = overlap_block_pair(
            blk, blk, CFG, self_block=True,
            hit_cap=1 << 20, seed_cap=1 << 15)
        for _, la, _, _ in outs:
            p, r = tmp_path / "p.las", tmp_path / "r.las"
            write_las(str(p), la)
            write_las(str(r), ref_a)
            assert p.read_bytes() == r.read_bytes()


class TestSlicedSeeding:
    """The 200 Mbp-class sliced seeding pipeline (chunked emitting-
    tuple partition + per-b-read-slice fill/banding + seed merge) must
    be BIT-IDENTICAL — same seeds, same order, same totals — to the
    single-buffer pipeline.  Forced on at tiny caps via the module
    thresholds."""

    def _run(self, blk_a, blk_b, cfg, self_pair, **kw):
        import numpy as np
        from damar_tpu.ops.seeding import find_seeds_canonical_dev
        r = find_seeds_canonical_dev(blk_a, blk_b, cfg,
                                     self_pair=self_pair, **kw)
        return {k: np.asarray(v) if hasattr(v, "shape") else v
                for k, v in r.items()}

    def _check(self, blk_a, blk_b, self_pair, upper_only):
        import numpy as np
        from damar_tpu.core.config import OverlapConfig
        from damar_tpu.ops import seeding as S
        cfg = OverlapConfig()
        kw = dict(upper_only=upper_only, hit_cap=1 << 24,
                  seed_cap=1 << 16)
        r_u = self._run(blk_a, blk_b, cfg, self_pair, **kw)
        orig_cap, orig_chunk = S._SLICE_CAP, S._SLICE_CHUNK
        try:
            S._SLICE_CAP = 1 << 17
            S._SLICE_CHUNK = 1 << 19
            r_s = self._run(blk_a, blk_b, cfg, self_pair, **kw)
        finally:
            S._SLICE_CAP, S._SLICE_CHUNK = orig_cap, orig_chunk
        n = int(r_u["nseeds"])
        assert int(r_s["nseeds"]) == n and n > 0
        for k in ("aread", "bread", "apos", "bpos", "cov", "comp"):
            np.testing.assert_array_equal(r_u[k][:n], r_s[k][:n],
                                          err_msg=k)
        assert int(r_u["total_seeds"]) == int(r_s["total_seeds"])
        assert int(r_u["total_hits"]) == int(r_s["total_hits"])

    def test_self_pair_bit_identical(self):
        from damar_tpu.core.blocks import block_from_reads
        from damar_tpu.utils.sim import make_genome, sample_reads
        g = make_genome(150_000, seed=7)
        sim = sample_reads(g, coverage=8, mean_len=4000, err=0.13,
                           seed=8)
        blk = block_from_reads(sim.reads)
        self._check(blk, blk, self_pair=True, upper_only=True)

    def test_cross_pair_bit_identical(self):
        from damar_tpu.core.blocks import block_from_reads
        from damar_tpu.utils.sim import make_genome, sample_reads
        g = make_genome(150_000, seed=17)
        sim = sample_reads(g, coverage=10, mean_len=4000, err=0.13,
                           seed=18)
        half = len(sim.reads) // 2
        blk_a = block_from_reads(sim.reads[:half])
        blk_b = block_from_reads(sim.reads[half:])
        self._check(blk_a, blk_b, self_pair=False, upper_only=False)

    def test_empty_slice_ok(self):
        """A degenerate split (all hits on one side of br_mid) must
        still produce the identical result."""
        import numpy as np
        from damar_tpu.core.blocks import block_from_reads
        from damar_tpu.utils.sim import make_genome, sample_reads
        from damar_tpu.core.config import OverlapConfig
        from damar_tpu.ops import seeding as S
        g = make_genome(60_000, seed=27)
        sim = sample_reads(g, coverage=6, mean_len=3000, err=0.12,
                           seed=28)
        # B block with ONE read: br_mid=0 puts everything in slice 1
        blk_a = block_from_reads(sim.reads[:-1])
        blk_b = block_from_reads(sim.reads[-1:])
        cfg = OverlapConfig()
        kw = dict(upper_only=False, hit_cap=1 << 22, seed_cap=1 << 14)
        r_u = self._run(blk_a, blk_b, cfg, False, **kw)
        orig_cap, orig_chunk = S._SLICE_CAP, S._SLICE_CHUNK
        try:
            S._SLICE_CAP = 1 << 17
            S._SLICE_CHUNK = 1 << 19
            r_s = self._run(blk_a, blk_b, cfg, False, **kw)
        finally:
            S._SLICE_CAP, S._SLICE_CHUNK = orig_cap, orig_chunk
        n = int(r_u["nseeds"])
        assert int(r_s["nseeds"]) == n
        for k in ("aread", "bread", "apos", "bpos"):
            np.testing.assert_array_equal(r_u[k][:n], r_s[k][:n])


class TestDefaultCapsAndRetryTiers:
    def test_default_caps_scale_with_block(self):
        """Callers that name no caps get a seed buffer sized from the
        block and a hit cap far above any block's hit total (fixed
        small caps truncated 200 Mbp blocks)."""
        from types import SimpleNamespace
        from damar_tpu.pipeline.overlap import default_caps
        small = SimpleNamespace(cap=1 << 20)
        huge = SimpleNamespace(cap=1 << 28)
        assert default_caps(small, small) == (1 << 30, 1 << 17)
        assert default_caps(small, huge) == (1 << 30, 1 << 23)

    def test_retry_tiers_order(self):
        """bp64 first, then the wide DP — the one ladder the pair driver
        and the ring sweep share."""
        from damar_tpu import native
        from damar_tpu.pipeline import overlap as ov
        tiers = ov._retry_tiers(CFG)
        assert tiers[-1] is ov._wide_trace_kernel(CFG)
        if native.available():
            assert tiers == [ov._native_bp64_trace, ov._native_wide_trace]
