"""Count-phase checkpoint/resume from the CLI surface (-ckpt): a run
killed mid-count resumes on rerun and produces a byte-identical model +
database (VERDICT r4 item 6 — the accumulators' checkpoint APIs now have a
driver surface)."""

import os

import numpy as np
import pytest

from kmcex import cli


def _write_fastq(path, n_reads, read_len=60, seed=3):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 100_000)
    with open(path, "wb") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, len(genome) - read_len))
            seq = acgt[genome[s : s + read_len]].tobytes()
            f.write(b"@r%d\n" % i)
            f.write(seq + b"\n+\n" + b"I" * read_len + b"\n")


@pytest.fixture()
def env(monkeypatch):
    # small batches so the input spans several, checkpoint every batch
    monkeypatch.setenv("KMCEX_CKPT_EVERY", "1")
    monkeypatch.setenv("KMCEX_BATCH_SEGS", "512")
    yield monkeypatch


def _model_files(workdir, db):
    base = os.path.basename(db)
    d = os.path.join(workdir, base)
    return [os.path.join(d, n) for n in ("header", "km.bin", "rest.bin")] + [
        db + ".kmc_pre", db + ".kmc_suf"]


def test_cli_kill_and_resume_byte_identical(tmp_path, env):
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=2500)
    k = "-k19"

    # uninterrupted reference run
    wd1 = tmp_path / "wd1"
    wd1.mkdir()
    db1 = str(tmp_path / "db1")
    assert cli.main(["kmcex", k, str(fq), db1, str(wd1)]) == 0

    # crashed run: dies after 2 batches, with checkpoints taken
    ck = str(tmp_path / "ck")
    wd2 = tmp_path / "wd2"
    wd2.mkdir()
    db2 = str(tmp_path / "db2")
    env.setenv("KMCEX_CRASH_AFTER_BATCHES", "2")
    with pytest.raises(RuntimeError, match="injected crash"):
        cli.main(["kmcex", k, f"-ckpt{ck}", str(fq), db2, str(wd2)])
    assert os.path.exists(os.path.join(ck, "manifest.json"))
    import json

    n_ck = json.load(open(os.path.join(ck, "manifest.json")))["extra"][
        "n_batches"]
    assert n_ck >= 1

    # resume: same command, crash disabled -> completes from the checkpoint
    env.delenv("KMCEX_CRASH_AFTER_BATCHES")
    assert cli.main(["kmcex", k, f"-ckpt{ck}", str(fq), db2, str(wd2)]) == 0
    # manifest retired on success
    assert not os.path.exists(os.path.join(ck, "manifest.json"))

    for f1, f2 in zip(_model_files(str(wd1), db1), _model_files(str(wd2), db2)):
        with open(f1, "rb") as a, open(f2, "rb") as b:
            assert a.read() == b.read(), (f1, f2)


def test_ckpt_fingerprint_mismatch_raises(tmp_path, env):
    from kmcex.count.pipeline import count_encode

    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=1200)
    ck = str(tmp_path / "ck")
    env.setenv("KMCEX_CRASH_AFTER_BATCHES", "1")
    with pytest.raises(RuntimeError):
        count_encode(str(fq), k=19, batch_segs=256, ckpt_dir=ck,
                     ckpt_every=1)
    env.delenv("KMCEX_CRASH_AFTER_BATCHES")
    with pytest.raises(ValueError, match="different input"):
        count_encode(str(fq), k=21, batch_segs=256, ckpt_dir=ck,
                     ckpt_every=1)


def test_ckpt_resume_device_acc_direct(tmp_path, env):
    """count_encode-level resume on the device accumulator, model equality
    against an uninterrupted run (no CLI, sharded variant covered in
    test_sharded)."""
    from kmcex.count.pipeline import count_encode

    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=2000, seed=11)
    km0, kk, cc, _ = count_encode(str(fq), k=19, batch_segs=256)

    ck = str(tmp_path / "ck")
    env.setenv("KMCEX_CRASH_AFTER_BATCHES", "3")
    with pytest.raises(RuntimeError):
        count_encode(str(fq), k=19, batch_segs=256, ckpt_dir=ck,
                     ckpt_every=1)
    env.delenv("KMCEX_CRASH_AFTER_BATCHES")
    km1, k1, c1, _ = count_encode(str(fq), k=19, batch_segs=256, ckpt_dir=ck,
                                  ckpt_every=1)
    np.testing.assert_array_equal(kk, k1)
    np.testing.assert_array_equal(cc, c1)
    d0 = tmp_path / "m0"
    d1 = tmp_path / "m1"
    km0.save(d0)
    km1.save(d1)
    for n in ("header", "km.bin", "rest.bin"):
        assert (d0 / n).read_bytes() == (d1 / n).read_bytes(), n