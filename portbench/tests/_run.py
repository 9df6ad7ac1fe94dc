"""Runs the benchmark's command in a subprocess and returns its result."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(*args: str, timeout: float = 600):
    """(exit code, last line of stdout as JSON or None, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    done = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    lines = done.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return done.returncode, last, done.stderr


def rehearse(workload: str, *extra: str, seed: int = 3000000019):
    return run("--workload", workload, "--seed", str(seed), "--seconds", "1", "--rehearse",
               *extra)
