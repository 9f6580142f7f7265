"""CLI smoke tests: every tool runs end-to-end on a small simulated
dataset through cli.main (the reference's user surface is ~30 Unix
tools; this guards the wiring of all of ours)."""
import json
import os

import numpy as np
import pytest

from damar_tpu import cli
from damar_tpu.utils.sim import make_genome, sample_reads, write_sim_fasta

OCFG = ["-l", "800"]


@pytest.fixture(scope="module")
def work(tmp_path_factory, capsys_disabled=None):
    w = tmp_path_factory.mktemp("cliwork")
    g = make_genome(30_000, seed=81)
    sim = sample_reads(g, coverage=8, mean_len=3000, err=0.12, seed=82,
                       min_len=1500)
    fa = str(w / "reads.fasta")
    write_sim_fasta(fa, sim)
    db = str(w / "E.db")
    cli.main(["fasta2db", db, fa])
    cli.main(["dbsplit", db, "-s", "1", "-x", "1000"])
    return dict(w=str(w), db=db, fa=fa, sim=sim)


def run(args):
    try:
        cli.main(args)
    except SystemExit as e:          # some tools exit explicitly
        assert (e.code or 0) == 0, args


class TestDbTools:
    def test_db_tools(self, work, capsys):
        db = work["db"]
        run(["dbstats", db])
        assert "reads" in capsys.readouterr().out
        run(["dbshow", db, "0", "1"])
        assert ">" in capsys.readouterr().out
        out_fa = os.path.join(work["w"], "back.fasta")
        run(["db2fasta", db, "-o", out_fa])
        assert os.path.getsize(out_fa) > 1000
        run(["dbdust", db])

    def test_masking_tools(self, work, capsys):
        db = work["db"]
        run(["datander", db])
        run(["tkshow", db, "dust", "0"])
        capsys.readouterr()


class TestOverlapTools:
    @pytest.fixture(scope="class")
    def las1(self, work):
        db = work["db"]
        p = os.path.join(work["w"], "E.1.E.1.las")
        cli.main(["daligner", db, "1", "1", "-o", p] + OCFG)
        return p

    def test_daligner_lacheck(self, work, las1, capsys):
        run(["lacheck", work["db"], las1])
        assert "OK" in capsys.readouterr().out
        run(["lashow", las1, "--limit", "5"])
        assert "[" in capsys.readouterr().out
        run(["lashow", las1, "--limit", "1", "-a", "--db", work["db"]])
        out = capsys.readouterr().out
        assert "|" in out          # alignment rendering present

    def test_sort_merge_cat_split(self, work, las1, capsys):
        w = work["w"]
        run(["lasort", las1])
        m = os.path.join(w, "m.las")
        run(["lamerge", m, las1, las1])
        c = os.path.join(w, "c.las")
        run(["lacat", c, las1, las1])
        run(["lasplit", work["db"], las1])
        capsys.readouterr()

    def test_overlap_all_and_plan(self, work, capsys):
        run(["hpc-plan", work["db"]])
        plan = capsys.readouterr().out
        assert "daligner" in plan
        run(["overlap-all", work["db"]] + OCFG)
        st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert st["pairs"] + st["skipped"] >= 1

    def test_scrub_tools(self, work, las1, capsys):
        db, w = work["db"], work["w"]
        st_las = os.path.join(w, "st.las")
        run(["lastitch", db, las1, "-o", st_las] + OCFG)
        run(["laq", db, st_las])
        run(["lagap", db, st_las])
        run(["repmask", db, st_las, "--low", "1.5", "--high", "2.0"])
        f_las = os.path.join(w, "f.las")
        run(["lafilter", db, st_las, "-o", f_las])
        fix_fa = os.path.join(w, "fix.fasta")
        run(["lafix", db, st_las, fix_fa])
        assert os.path.getsize(fix_fa) > 1000
        capsys.readouterr()

    def test_graph_tools(self, work, las1, capsys):
        db, w = work["db"], work["w"]
        gml = os.path.join(w, "g.graphml")
        run(["ogbuild", db, las1, gml, "--min-dovetail", "800"])
        assert os.path.getsize(gml) > 100
        lay = os.path.join(w, "lay.graphml")
        svg = os.path.join(w, "lay.svg")
        run(["oglayout", db, las1, lay, "--svg", svg,
             "--min-dovetail", "800"])
        assert b"<svg" in open(svg, "rb").read()
        run(["ctanalyze", db, las1, "--min-dovetail", "800"])
        contigs = os.path.join(w, "ctg.fasta")
        run(["assemble", db, las1, contigs, "--min-dovetail", "800"])
        assert os.path.getsize(contigs) > 1000
        # staged path: ogtour -> tours.json -> tour2fasta must equal
        # the one-shot assemble output (same walks, same stitching)
        tours = os.path.join(w, "tours.json")
        run(["ogtour", db, las1, tours, "--min-dovetail", "800"])
        assert json.load(open(tours))["tours"]
        ctg2 = os.path.join(w, "ctg2.fasta")
        run(["tour2fasta", db, tours, ctg2])
        from damar_tpu.formats.fasta import read_fasta
        _, s1 = read_fasta(contigs)
        _, s2 = read_fasta(ctg2)
        assert sorted(len(s) for s in s1) == sorted(len(s) for s in s2)
        capsys.readouterr()


class TestPlanExecution:
    def test_rendered_plan_lines_execute(self, work, capsys):
        """hpc-plan's rendered shell lines must run as-is from an
        arbitrary workdir (the shared-filesystem job contract): the
        PYTHONPATH prologue makes the checkout importable and
        JAX_PLATFORMS pins the backend in fresh processes."""
        import io
        import contextlib
        import subprocess
        db, w = work["db"], work["w"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(["hpc-plan", db])
        script = buf.getvalue()
        lines = script.splitlines()
        head = [l for l in lines if l.startswith("export")]
        jobs = [l for l in lines if l.startswith("python")][:1]
        assert head and jobs, script[:200]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run("\n".join(head + jobs), shell=True, cwd=w,
                           env=env, capture_output=True, text=True,
                           timeout=240)
        assert r.returncode == 0, r.stderr[-400:]
        capsys.readouterr()
