"""Set-up that decides where the program runs and what it builds: the
compile cache's directory, native libraries built from source, the
one-process-per-GPU rule of --hosts, and the smoke run's refusal to run
without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_after_enable(env_value):
    code = ("import jax\n"
            "from pindel_tpu.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_compile_cache_defaults_inside_checkout():
    used, configured = _cache_dir_after_enable(None)
    assert used == configured == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_env_var_is_left_to_jax(tmp_path):
    used, configured = _cache_dir_after_enable(str(tmp_path / "cc"))
    assert used == configured == str(tmp_path / "cc")


def test_native_library_concurrent_build(tmp_path):
    """Two processes building the same library at once both load a
    complete shared object, and no temp file is left behind."""
    shutil.copy(os.path.join(REPO, "pindel_tpu", "native", "packer.cpp"),
                tmp_path)
    code = ("import sys, ctypes\n"
            "import pindel_tpu.native as n\n"
            "n._DIR = sys.argv[1]\n"
            "ctypes.CDLL(n._build('ptpack', ['packer.cpp'], link=()))"
            ".pt_pack_close\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    names = sorted(os.listdir(tmp_path))
    assert "libptpack.so" in names
    assert not [n for n in names if n.endswith(".tmp")], names


def test_hosts_refused_on_gpu(tmp_path, monkeypatch):
    """--hosts N > 1 with a device backend on a GPU stops before starting
    any worker and points to --backend mesh."""
    import jax

    from pindel_tpu.__main__ import main
    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    ref, _events, reads = standard_scene(seed=1, chrom_len=20_000)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chrT", ref)])
    txt = str(tmp_path / "reads.txt")
    reads.write(txt)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    spawned = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(SystemExit, match="--backend mesh"):
        main(["-f", fa, "-p", txt, "-o", str(tmp_path / "out"),
              "--hosts", "2", "--backend", "fused"])
    assert not spawned


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr
