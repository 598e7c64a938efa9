"""The benchmark finds every configuration, mix and metric by name, a cell
is added by files alone, nothing of it loads JAX or the JAX package, and
a run without a card prints no result."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

from gpubench import registry

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "flate_tpu"}


def test_every_cell_and_metric_resolves():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cfg = registry.config(bench, w["config"])
        mix = registry.mix(w["traffic"])
        op = registry.op(mix["op"])
        for fn in ("prepare", "call", "sizes", "after_window", "check"):
            assert callable(getattr(op, fn))
        assert callable(registry.corpus(mix["corpus"]).make)
        assert cfg["file_bytes"] > 0
        for traced in (False, True):
            for m in registry.metrics(bench, w["name"], traced):
                kind = "layer_metrics" if traced else "e2e_metrics"
                assert callable(registry.reader(kind, m["name"]))
        e2e = {m["name"] for m in registry.metrics(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics(bench, w["name"], True)


def test_no_module_of_the_benchmark_imports_jax():
    """Every import in gpubench/, by whole top-level name: flate_tpu_torch
    begins with flate_tpu but is another name."""
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, path


def _python(code: str, cwd=ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_run_imports_load_no_jax():
    """The modules a run loads, the program with them, leave no JAX and no
    JAX package in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import gpubench.run as run, gpubench.harness\n"
        "import gpubench.registry as r\n"
        "import flate_tpu_torch, flate_tpu_torch.api\n"
        "b = r.benchmark()\n"
        "for w in b['workloads']:\n"
        "    m = r.mix(w['traffic']); r.op(m['op']); r.corpus(m['corpus'])\n"
        "    for t in (0, 1):\n"
        "        for x in r.metrics(b, w['name'], t):\n"
        "            kind = 'layer_metrics' if t else 'e2e_metrics'\n"
        "            r.reader(kind, x['name'])\n"
        "print(run.loaded_forbidden())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    p = _python(code, env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]", p.stdout


def test_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "pigz6-encode-32M",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip(), p.stdout
    assert "no result" in p.stderr


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell and a
    per-layer metric by new files and new entries in BENCHMARK.json; every
    file already there stays as it was, and a run of the new cell (on the
    CPU, at a small size) reports the new metric."""
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "gpubench").rglob("*")
              if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(bench))

    g = tmp_path / "gpubench"
    cfg = json.loads((g / "configs" / "pigz-l6.json").read_text())
    cfg.update(name="pigz-small", shard_len=16384, ctx=4096,
               encode_batch=2, file_bytes=98304)
    (g / "configs" / "pigz-small.json").write_text(json.dumps(cfg))
    (g / "mixes" / "encode-other.json").write_text(json.dumps(
        {"why": "x", "op": "compress", "corpus": "mixed", "pool": 2,
         "trace_calls": 2}))
    (g / "layer_metrics" / "member_bytes.encode.py").write_text(
        "def read(run):\n"
        "    return sum(c.n_out for c in run.done) / len(run.done)\n")
    bench["configs"].append({"name": "pigz-small", "source": "x",
                             "file": "gpubench/configs/pigz-small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "pigz-small-encode-other",
                               "chips": 1, "config": "pigz-small",
                               "traffic": "encode-other",
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_gbps":
            m["workloads"].append("pigz-small-encode-other")
    bench["per_layer"].append({"name": "member_bytes.encode", "unit": "B",
                               "better": "lower", "source": "host_clock",
                               "layer": "encode host loop",
                               "moves": "encode_gbps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        f"import sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from gpubench import harness, registry\n"
        f"assert harness.__file__.startswith({str(tmp_path)!r})\n"
        "b = registry.benchmark()\n"
        "for t in (False, True):\n"
        "    r = harness.run_cell(b, 'pigz-small-encode-other', 3, 0.5, t,\n"
        "                         'cpu', time.perf_counter())\n"
        "    assert r['correct'], r\n"
        "    print(sorted(r['metrics']))\n")
    p = _python(code, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    untraced, traced = p.stdout.strip().splitlines()[-2:]
    assert untraced == "['encode_gbps', 'setup_s']"
    assert "member_bytes.encode" in traced
    for path, data in before.items():
        assert path.read_bytes() == data, path
    # BENCHMARK.json only gained entries
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in bench[key]}
        assert {e["name"] for e in old[key]} <= names
