"""chip_smoke.py refuses the CPU, and its oracle and comparison helpers
agree with the pipeline on a tiny input (the phases themselves need the
GPU and run only there)."""

import os
import pathlib
import subprocess
import sys

import numpy as np

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_helpers_agree_on_tiny_input(tmp_path):
    """The CPU run of the smoke's own phases 2-4 at a tiny size: numpy
    oracle == KMC listing, CLI model == host model == model-only model,
    device queries == host queries."""
    fq = str(tmp_path / "reads.fastq")
    chip_smoke.make_input(fq, genome_len=3000, n_reads=400, seed=5)
    oracle = chip_smoke.oracle_pairs(fq)
    assert len(oracle[0]) > 1000 and oracle[1].min() >= 1
    # the oracle's canonical form agrees with the codec's
    from kmcex.core import codec

    assert np.array_equal(codec.canonical_np(oracle[0], 31), oracle[0])
    want = chip_smoke.phase_cli(fq, str(tmp_path), oracle, "cpu")
    km = chip_smoke.phase_model_only(fq, str(tmp_path), want, "cpu", reps=1)
    chip_smoke.phase_query(km, oracle[0], "cpu", n=4096)
