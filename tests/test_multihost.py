"""Multi-host simulation: windows sharded across processes must produce
byte-identical reports to a single-process run (parallel/multihost.py).

The scene spans several windows (small -w) so both processes actually
search windows; workers run as real subprocesses exchanging searched
windows through the file spool — the local stand-in for DCN shipping of
anchor tables between machines.
"""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_fai import make_fai  # noqa: E402

SUFFIXES = ("D", "SI", "TD", "INV", "LI", "BP", "CloseEndMapped",
            "INT_final")


def _scene(tmp_path, chrom_len=260_000, n_events=24):
    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    kinds = ["DEL", "SI", "DI", "INV", "TD", "LI"] * (n_events // 6)
    ref, events, reads = standard_scene(
        seed=77, chrom_len=chrom_len, kinds=kinds,
        reads_per_event=8, n_noise=300, chrom="chrM")
    d = str(tmp_path)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrM", ref)])
    make_fai(fa)
    txt = os.path.join(d, "reads.txt")
    reads.write(txt)
    return d, fa, txt


@pytest.mark.parametrize("hosts,backend", [
    (2, "numpy"),
    # fused workers inherit JAX_PLATFORMS (cpu under pytest) from the
    # coordinator's environment
    (3, "fused"),
])
def test_multihost_byte_identical(tmp_path, hosts, backend):
    d, fa, txt = _scene(tmp_path)
    from pindel_tpu.__main__ import main
    # -w 0.05 => 50 kb windows: ~6 windows over the scene
    base = ["-f", fa, "-p", txt, "-w", "0.05", "-l", "-k", "-s",
            "--backend", backend]
    assert main([*base, "-o", os.path.join(d, "single")]) == 0
    assert main([*base, "-o", os.path.join(d, "multi"),
                 "--hosts", str(hosts)]) == 0
    for suf in SUFFIXES:
        single = open(os.path.join(d, f"single_{suf}")).read()
        multi = open(os.path.join(d, f"multi_{suf}")).read()
        assert multi == single, f"_{suf} differs with --hosts {hosts}"
    assert open(os.path.join(d, "single_D")).read()   # scene nonempty


def test_multihost_spool_assignment():
    from pindel_tpu.parallel.multihost import WindowSpool
    sp = WindowSpool("/tmp", rank=1, num_hosts=3, worker=True)
    assert [w for w in range(9) if sp.mine(w)] == [1, 4, 7]


def test_payload_roundtrip():
    """pack/unpack of searched reads is lossless for every field the
    report stage consumes, and the wire format is pure arrays."""
    import numpy as np

    from pindel_tpu.config import Settings
    from pindel_tpu.parallel import payload
    from pindel_tpu.search import Searcher
    from test_search_semantics import make_genome, sample_reads, ups_key

    rng = np.random.default_rng(55)
    g = make_genome(rng)
    chrom = g.chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=40)
    searcher = Searcher(Settings())
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    searcher.search_far_ends(chrom, kept)
    assert kept

    arrs = payload.pack(kept)
    for k, v in arrs.items():
        assert isinstance(v, np.ndarray), k
        assert v.dtype.kind in "iub", (k, v.dtype)     # no object arrays
    # savez/load round trip with pickling forbidden
    import io
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    buf.seek(0)
    with np.load(buf, allow_pickle=False) as z:
        back = payload.unpack({k: z[k] for k in z.files})
    assert len(back) == len(kept)
    for a, b in zip(kept, back):
        for col in ("name", "frag_name", "far_frag_name", "matched_d",
                    "matched_far_d", "tag", "seq", "matched_rel_pos",
                    "ms", "insert_size", "max_snp_error",
                    "close_end_mismatch", "far_end_mismatch",
                    "left_most_pos", "mapper_split", "unique_read"):
            assert getattr(a, col) == getattr(b, col), col
        assert ups_key(a.up_close) == ups_key(b.up_close)
        assert ups_key(a.up_far) == ups_key(b.up_far)
        assert b.sample_name_to_number == {a.tag: 1}


def test_multihost_bam_input_with_breakdancer(tmp_path):
    """--hosts with BAM input: every rank replays the sequential RP->BD
    evidence, so the evidence-guided far-end path (BD windows beyond the
    geometric ladder) stays byte-identical to a single-process run."""
    import sys as _sys
    _sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_breakdancer import _big_del_scene
    from pindel_tpu.testing.bamwriter import anchored_pair
    from pindel_tpu.testing.bamwriter import write_bam

    d, fa, txt, bd, events = _big_del_scene(tmp_path)
    ref = open(fa).read().split("\n", 1)[1].replace("\n", "")
    lines = open(txt).read().splitlines()
    recs = []
    for i in range(0, len(lines), 3):
        name, seq, meta = lines[i], lines[i + 1], lines[i + 2].split()
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        if anchor_pos < 0 or anchor_pos + 100 > len(ref):
            continue
        recs.extend(anchored_pair(name[1:-2], anchor_pos, seq, ref,
                                  anchor_reverse=(dstr == "-"), mapq=mq))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")

    from pindel_tpu.__main__ import main
    # -w 0.01 => 10 kb windows over the 60 kb scene: several windows so
    # ownership really alternates
    base = ["-f", fa, "-i", cfg, "-b", bd, "-w", "0.01", "-s",
            "--backend", "fused"]
    assert main([*base, "-o", os.path.join(d, "single")]) == 0
    assert main([*base, "-o", os.path.join(d, "multi"),
                 "--hosts", "2"]) == 0
    for suf in ("D", "SI", "TD", "INV", "CloseEndMapped", "RP",
                "INT_final"):
        single = open(os.path.join(d, f"single_{suf}")).read()
        multi = open(os.path.join(d, f"multi_{suf}")).read()
        assert multi == single, f"_{suf} differs with --hosts 2 (BAM)"
    # the BD-guided 6 kb deletion is present in both
    assert "D 6000" in open(os.path.join(d, "single_D")).read()


def test_multihost_jax_distributed_transport(tmp_path):
    """--dist jax: the pod-shaped transport — packed anchor tables over
    jax.distributed broadcast collectives (parallel/distspool.py) —
    byte-identical to single-process.  Both ranks run as fresh
    subprocesses (jax.distributed must initialize before backend use;
    the pytest process's jax is already live)."""
    import subprocess
    import sys as _sys

    d, fa, txt = _scene(tmp_path, chrom_len=140_000, n_events=12)
    from pindel_tpu.__main__ import main
    base = ["-f", fa, "-p", txt, "-w", "0.05", "-l", "-s",
            "--backend", "numpy"]
    assert main([*base, "-o", os.path.join(d, "single")]) == 0

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [_sys.executable, "-m", "pindel_tpu", *base,
         "-o", os.path.join(d, "multi"), "--hosts", "2", "--dist", "jax"],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    for suf in ("D", "SI", "TD", "INV", "LI", "CloseEndMapped"):
        single = open(os.path.join(d, f"single_{suf}")).read()
        multi = open(os.path.join(d, f"multi_{suf}")).read()
        assert multi == single, f"_{suf} differs with --dist jax"
    assert open(os.path.join(d, "single_D")).read()
