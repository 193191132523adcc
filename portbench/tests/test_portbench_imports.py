"""What the harness and the reference import."""
import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "textboost_tpu"}


def loaded(modules):
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_what_it_drives_load_no_jax():
    """The harness, both generators and the package modules they call: no
    top-level name jax, jaxlib, flax or textboost_tpu (compared whole: the
    port's name begins with the JAX package's)."""
    tops = loaded(["portbench.run", "portbench.harness", "portbench.traffic.train",
                   "portbench.traffic.sample", "textboost_torch.train.trainer",
                   "textboost_torch.pipelines.loading", "textboost_torch.eval.__main__"])
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "textboost_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    tops = loaded(["portbench.reference.models", "portbench.reference.train",
                   "portbench.reference.sample", "portbench.reference.quant",
                   "portbench.reference.tokenizer"])
    assert not tops & (FORBIDDEN | {"textboost_torch"}), tops


def test_no_source_under_the_reference_names_the_program():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"textboost_torch"}, (path, n)
