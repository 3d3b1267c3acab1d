"""One parity row through both packages' harnesses on the CPU, on the
same rendered dataset.

    python3 tools/parity_cpu.py loop_st
    python3 tools/parity_cpu.py loop:240 --ba-every 10

Renders the row with `rebvo_tpu_torch.apps.parity.render_dataset` (the
JAX package's seeds; its pixels equal the JAX harness's,
tests/test_torch_parity.py) under build/parity_cpu/port/, copies it to
build/parity_cpu/jax/, then runs `python -m rebvo_tpu.apps.parity` and
`python -m rebvo_tpu_torch.apps.parity --cpu`, each with `--skip-ref
--reuse`, in their own interpreters, and prints both rows as one JSON
line. This process imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rebvo_tpu_torch.apps import parity  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("seq", help="KIND or KIND:FRAMES (default 240 frames)")
    ap.add_argument("--ba-every", type=int, default=0)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                      "parity_cpu"))
    args = ap.parse_args(argv)

    kind, _, nf = args.seq.partition(":")
    n = int(nf or 240)
    base = kind[:-3] if kind.endswith("_b0") else kind
    dirs = {p: os.path.join(args.out_dir, p) for p in ("port", "jax")}
    seq_dir = os.path.join(dirs["port"], base)
    if not os.path.exists(os.path.join(seq_dir, "gt_pos.txt")):
        parity.render_dataset(seq_dir, base, n, parity.seq_seed(base))
    shutil.rmtree(os.path.join(dirs["jax"], base), ignore_errors=True)
    shutil.copytree(seq_dir, os.path.join(dirs["jax"], base),
                    ignore=shutil.ignore_patterns("repo_out*"))
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               REBVO_COMPILE_CACHE=os.path.join(args.out_dir, "jax_cache"))
    rows = {}
    for pkg, extra in (("jax", []), ("port", ["--cpu"])):
        module = ("rebvo_tpu" if pkg == "jax" else "rebvo_tpu_torch") + \
            ".apps.parity"
        out = os.path.join(dirs[pkg], "parity.json")
        cmd = [sys.executable, "-m", module, "--skip-ref", "--reuse",
               "--seqs", f"{kind}:{n}", "--out-dir", dirs[pkg], "--json",
               out, "--ba-every", str(args.ba_every)] + extra
        subprocess.run(cmd, cwd=ROOT, env=env, check=True,
                       capture_output=True, text=True)
        with open(out) as fh:
            rows[pkg] = json.load(fh)["sequences"][0]
    print(json.dumps({"device": "cpu", **rows}))


if __name__ == "__main__":
    main()
