"""Nothing the benchmark loads is JAX or the JAX package.

A fresh process loads `bench/run.py`, every reader and reference the
benchmark names, and the harness with the port modules it drives (a tiny
cell run on the CPU, traced and not, through the function `run.py`
calls), then lists the top-level names of `sys.modules`.  Names are
compared whole: the port, `repro_torch`, is not the JAX package,
`repro`.
"""
import json
import subprocess
import sys
import textwrap

from bench.tests import _tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

SCRIPT = textwrap.dedent("""
    import importlib.util, json, sys, tempfile, time
    from pathlib import Path
    repo = Path(sys.argv[1])
    sys.path[:0] = [str(repo / "src"), str(repo)]
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  repo / "bench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from bench.harness import cell, spec as bspec
    from bench.tests._tiny import tiny_root
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = bspec.load_cell(repo, w["name"])
        c.reference()
        for trace in (False, True):
            for m in c.metrics(trace):
                c.reader(m, trace)
    root = tiny_root(Path(tempfile.mkdtemp()))
    for name in ("tiny-serve", "tiny-moe"):
        for trace in (False, True):
            cell.run_cell(bspec.load_cell(root, name), 5, 0.5, trace,
                          "cpu", time.perf_counter())
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")


def test_nothing_loaded_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(_tiny.REPO)],
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
