"""The port's host tools (``multimodal_clinical_tpu_torch/tools``:
``analyze_runs``, ``noise_sweep``, ``parity_run``, ``preprocess``) against
the JAX package's ``tools/`` on the CPU, mirroring ``tests/test_tools.py``
and ``tests/test_parity_run.py``.

What is compared: files the two tools write from the same inputs, byte
for byte, except the spectrogram pickles, which hold the port's
``cremad_spectrogram`` (an FFT) against JAX's (a matmul DFT) to 5e-5
absolute on their standardised values (``test_torch_port_cremad.py``'s
``JAX_TOL``).  ``noise_sweep`` and ``parity_run`` train through the port
for real; the JAX tool then runs on the port's results (its
``run_multiseed`` or ``run_training`` replaced by one that hands them
back), so the two write their artifacts and verdicts from the same
numbers and must write them identically.
"""

import csv
import gzip
import io
import json
import os
import pickle
import shutil
import sys
import tarfile
import wave

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu_torch.data import synthetic
from multimodal_clinical_tpu_torch.engine import multiseed
from multimodal_clinical_tpu_torch.tools import (
    analyze_runs, noise_sweep, parity_run, preprocess,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import analyze_runs as jax_analyze  # noqa: E402
import noise_sweep as jax_noise_sweep  # noqa: E402
import preprocess as jax_preprocess  # noqa: E402

torch.set_num_threads(2)

SPEC_ATOL = 5e-5


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write_wav(path, samples, sr=16000):
    pcm = (np.clip(samples, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


# -- analyze_runs --------------------------------------------------------

def _runs(root):
    """Two seed sweeps (seeds.csv) and one single run (metrics.jsonl)."""
    dirs = []
    for name, accs in (("jl", (0.80, 0.70)), ("en", (0.75, 0.72))):
        run_dir = root / name
        run_dir.mkdir()
        with open(run_dir / "seeds.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["seed", "test_epoch/test_avg_acc",
                        "test_epoch/test_avg_x1_acc",
                        "test_epoch/test_avg_x2_acc",
                        "test_epoch/test_avg_loss"])
            for s, acc in enumerate(accs):
                w.writerow([s, acc, acc - 0.1, acc - 0.05, 1.25 + s / 3])
            w.writerow(["mean", sum(accs) / 2, "", "", ""])
            w.writerow(["std", 0.01, "", "", ""])
        dirs.append(run_dir)
    single = root / "single"
    single.mkdir()
    with open(single / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"epoch": 0, "val_epoch/val_avg_acc": 0.5,
                            "train_epoch/train_avg_loss": 1.5}) + "\n")
        f.write(json.dumps({"epoch": -1, "test_epoch/test_avg_acc": 0.625,
                            "test_epoch/test_avg_loss": 1.0 / 3}) + "\n")
    return dirs, single


def test_analyze_runs_export_and_compare_byte_identical(tmp_path, capsys):
    (jl, en), single = _runs(tmp_path)
    for tag, tool in (("port", analyze_runs), ("jax", jax_analyze)):
        assert tool.export([str(jl), str(single)],
                           str(tmp_path / f"{tag}_jl.csv")) == 3
        assert tool.export([str(en)], str(tmp_path / f"{tag}_en.csv")) == 2
    for name in ("jl", "en"):
        assert _bytes(tmp_path / f"port_{name}.csv") == _bytes(
            tmp_path / f"jax_{name}.csv")
    capsys.readouterr()
    got = analyze_runs.compare(str(tmp_path / "port_jl.csv"),
                               str(tmp_path / "port_en.csv"))
    port_out = capsys.readouterr().out
    want = jax_analyze.compare(str(tmp_path / "jax_jl.csv"),
                               str(tmp_path / "jax_en.csv"))
    assert got == want and got["test_acc_epoch"] == 1
    assert port_out == capsys.readouterr().out
    # the CLI's subcommands
    analyze_runs.main(["export", "--run-dir", str(en), "--out",
                       str(tmp_path / "cli.csv")])
    assert _bytes(tmp_path / "cli.csv") == _bytes(tmp_path / "jax_en.csv")


# -- noise_sweep ---------------------------------------------------------

def test_noise_sweep_writes_jax_artifacts(tmp_path, monkeypatch):
    """Two noise levels, one model type, two seeds for one epoch on the
    twin shrunk to 32 x 16 screens (as ``tests/test_tools.py`` shrinks
    JAX's): the port trains; the JAX tool writes its CSVs from the port's
    summaries; the three CSVs are byte-identical and the PNG is drawn."""
    import multimodal_clinical_tpu.data.synthetic as jax_synthetic
    import multimodal_clinical_tpu.engine.multiseed as jax_multiseed

    monkeypatch.setitem(synthetic.BENCHMARK_SHAPES, "enrico",
                        [(32, 16, 3), (32, 16, 3)])
    runs = []
    real = multiseed.run_multiseed

    def recording(args, benchmark, seeds, device):
        summary = real(args, benchmark, seeds, device=device)
        runs.append((vars(args).copy(), list(seeds), summary))
        return summary

    monkeypatch.setattr(multiseed, "run_multiseed", recording)
    argv = ["--mode", "x1", "--probs", "0", "0.5", "--model-types",
            "jlogits", "--num-seeds", "2", "--num-epochs", "1"]
    noise_sweep.main(argv + ["--out-dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    replay = iter(runs)

    def replaying(args, benchmark, seeds):
        want_args, want_seeds, summary = next(replay)
        assert list(seeds) == want_seeds
        for key in ("noise_p", "label_noise_p", "group_name", "model_type",
                    "num_epochs"):
            assert getattr(args, key) == want_args[key], key
        return summary

    monkeypatch.setattr(jax_multiseed, "run_multiseed", replaying)
    monkeypatch.setitem(jax_synthetic.BENCHMARK_SHAPES, "enrico",
                        [(32, 16, 3), (32, 16, 3)])
    jax_noise_sweep.main(argv + ["--out-dir", str(tmp_path / "jax")])
    assert len(runs) == 2
    for name in ("data.csv", "data_x1.csv", "data_x2.csv"):
        assert _bytes(tmp_path / "port" / name) == _bytes(
            tmp_path / "jax" / name)
        rows = list(csv.reader(open(tmp_path / "port" / name)))
        assert rows[0] == ["noise_p", "jlogits_acc", "jlogits_std"]
        assert len(rows) == 3
    assert (tmp_path / "port" / "noise_experiment_combined.png").stat(
    ).st_size > 0


# -- parity_run ----------------------------------------------------------

def _verdict_lines(out):
    return [line for line in out.splitlines()
            if line.startswith(("[parity]", "  "))]


def _replay_run_training(monkeypatch, port_run_dirs, summaries):
    """JAX's ``main.run_training`` handing back the port's summary, with
    the port's run files copied where the JAX tool's export reads them."""
    import main as jax_main

    def replaying(argv):
        sets = dict(a.split("=", 1) for a in argv if "=" in a)
        src = port_run_dirs.pop(0)
        dst = os.path.join(sets.get("ckpt_dir") or sets["data_path"].rstrip(
            "/") + "_ckpts", sets["group_name"])
        shutil.copytree(src, dst, dirs_exist_ok=True)
        return summaries.pop(0)

    monkeypatch.setattr(jax_main, "run_training", replaying)


def _port_parity(monkeypatch, argv, keep):
    """The port's parity_run on the CPU; its run directory is copied to
    ``keep`` as soon as it is written (the tool removes a fixture's run
    when ``--out`` sends the CSV elsewhere).  Returns (rc, summary)."""
    from multimodal_clinical_tpu_torch import __main__ as cli

    seen = {}
    real = cli.run_training

    def recording(argv_run, device):
        seen["summary"] = real(argv_run, device=device)
        args = cli.setup_configs(argv_run)
        data_path = str(getattr(args, "data_path", "runs")).rstrip("/")
        shutil.copytree(os.path.join(
            getattr(args, "ckpt_dir", None) or f"{data_path}_ckpts",
            args.group_name), keep)
        return seen["summary"]

    monkeypatch.setattr(cli, "run_training", recording)
    rc = parity_run.main(argv + ["--device", "cpu"])
    return rc, seen.get("summary")


def test_parity_run_refuses_synthetic_as_jax_does(tmp_path, capsys):
    from tools.parity_run import main as jax_main

    argv = ["--dir", "mimic", "--model-type", "jlogits", "--seeds", "1",
            "--set", "num_epochs=1", "--set", f"data_path={tmp_path}/",
            "--set", f"ckpt_dir={tmp_path}/ckpts"]
    assert parity_run.main(argv + ["--device", "cpu"]) == 2
    port_out = capsys.readouterr().out
    assert jax_main(argv) == 2
    assert "SYNTHETIC twin" in port_out
    assert _verdict_lines(port_out) == _verdict_lines(capsys.readouterr().out)
    assert parity_run.main(["--dir", "food101", "--fixture"]) == 2


@pytest.mark.parametrize("bench,extra", [
    ("mimic", ["--model-type", "jlogits", "--seeds", "2"]),
    ("enrico", ["--set", "compute_dtype=float32"]),
], ids=["mimic", "enrico"])
def test_parity_run_fixture_gives_jax_verdicts(tmp_path, capsys,
                                               monkeypatch, bench, extra):
    """``--fixture`` fabricates the real on-disk layout (MIMIC's ``im.pk``,
    Enrico's csv and image directories) and drives train -> CSV ->
    verdict; at fixture scale every published target is REPORT-ONLY, on
    both sides alike, and the export CSVs are byte-identical."""
    from tools.parity_run import main as jax_main

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    argv = ["--dir", bench, "--fixture", "--out", str(tmp_path / "port.csv"),
            *extra]
    keep = str(tmp_path / "port_run")
    rc, summary = _port_parity(monkeypatch, argv, keep)
    port_out = capsys.readouterr().out
    assert rc == 0, port_out
    assert "synthetic=False" in port_out
    if bench == "mimic":
        assert "REPORT-ONLY (fixture)" in port_out
    assert "FAIL" not in port_out and ": PASS" not in port_out
    _replay_run_training(monkeypatch, [keep], [summary])
    argv[argv.index("--out") + 1] = str(tmp_path / "jax.csv")
    assert jax_main(argv) == 0
    jax_out = capsys.readouterr().out
    assert _verdict_lines(port_out) == _verdict_lines(jax_out)
    assert _bytes(tmp_path / "port.csv") == _bytes(tmp_path / "jax.csv")


# -- preprocess ----------------------------------------------------------

def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_cremad_audio_pickles_match_jax(tmp_path):
    wav_dir = tmp_path / "wav"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        _write_wav(wav_dir / f"clip{i}.wav",
                   rng.normal(scale=0.1, size=16000 * 2).astype(np.float32))
    preprocess.main(["cremad-audio", "--wav-dir", str(wav_dir), "--out",
                     str(tmp_path / "port"), "--batch-size", "2",
                     "--device", "cpu"])
    jax_preprocess.main(["cremad-audio", "--wav-dir", str(wav_dir), "--out",
                         str(tmp_path / "jax"), "--batch-size", "2"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "clip0.pkl", "clip1.pkl", "clip2.pkl"]
    for name in names:
        got, want = (_pickle(tmp_path / side / name)
                     for side in ("port", "jax"))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (257, 1004)
        np.testing.assert_allclose(got, want, rtol=0, atol=SPEC_ATOL)


def test_ave_audio_pickles_match_jax(tmp_path):
    d = tmp_path / "ave"
    (d / "Audios").mkdir(parents=True)
    rng = np.random.default_rng(1)
    for clip in ("clipA", "clipB", "clipC"):
        _write_wav(d / "Audios" / f"{clip}.wav",
                   rng.normal(scale=0.1, size=16000 * 3).astype(np.float32))
    (d / "Annotations.txt").write_text(
        "category&video&quality&start&end\n"
        "Dog&clipA&good&1&2\nCat&clipB&good&0&3\nDog&clipC&good&0&10\n"
        "Dog&missing&good&0&10\n")
    preprocess.main(["ave-audio", "--data-dir", str(d) + "/", "--out",
                     str(tmp_path / "port"), "--batch-size", "2",
                     "--device", "cpu"])
    jax_preprocess.main(["ave-audio", "--data-dir", str(d) + "/", "--out",
                         str(tmp_path / "jax"), "--batch-size", "2"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "clipA.pkl", "clipB.pkl", "clipC.pkl"]
    for name in names:
        np.testing.assert_allclose(_pickle(tmp_path / "port" / name),
                                   _pickle(tmp_path / "jax" / name),
                                   rtol=0, atol=SPEC_ATOL)


def test_device_subcommands_need_cuda_unless_given_cpu(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preprocess.main(["cremad-audio", "--wav-dir", str(tmp_path),
                         "--out", str(tmp_path / "o")])


def _both(tmp_path, argv_of):
    """Run a subcommand through both tools, each writing under its own
    directory; returns the two directories."""
    out = {}
    for side, tool in (("port", preprocess), ("jax", jax_preprocess)):
        out[side] = tmp_path / side
        out[side].mkdir()
        tool.main(argv_of(out[side]))
    return out["port"], out["jax"]


def test_ave_segments_byte_identical(tmp_path):
    (tmp_path / "Annotations.txt").write_text(
        "header\nDog&clipA&good&1&4\nCat&clipB&good&0&10\n")
    for target in ("frames", "audio"):
        sub = tmp_path / target
        sub.mkdir()
        port, jax_dir = _both(sub, lambda d: [
            "ave-segments", "--data-dir", str(tmp_path) + "/", "--out",
            str(d / "seg.csv"), "--for", target])
        assert _bytes(port / "seg.csv") == _bytes(jax_dir / "seg.csv")


def test_check_frames_and_fix_missing_as_jax(tmp_path, capsys):
    root = tmp_path / "frames"
    for clip, n in (("a", 6), ("b", 2)):
        (root / clip).mkdir(parents=True)
        for i in range(n):
            (root / clip / f"f{i}.jpg").touch()
    preprocess.main(["check-frames", "--frames-root", str(root),
                     "--min-frames", "6"])
    port_out = capsys.readouterr().out
    jax_preprocess.main(["check-frames", "--frames-root", str(root),
                         "--min-frames", "6"])
    assert port_out == capsys.readouterr().out
    assert "1 clip dirs" in port_out
    data_root = tmp_path / "clips"
    data_root.mkdir()
    (data_root / "a.wav").touch()
    (data_root / "vidA_000030.wav").touch()
    with open(tmp_path / "list.csv", "w", newline="") as f:
        csv.writer(f).writerows([["a", "cls1"], ["missing", "cls2"],
                                 ["vidA", "30", "dog", "train"],
                                 ["vidB", "7", "cat", "train"]])
    port, jax_dir = _both(tmp_path, lambda d: [
        "fix-missing", "--csv-file", str(tmp_path / "list.csv"),
        "--data-root", str(data_root), "--out", str(d / "fixed.csv")])
    assert _bytes(port / "fixed.csv") == _bytes(jax_dir / "fixed.csv")
    assert list(csv.reader(open(port / "fixed.csv"))) == [
        ["a", "cls1"], ["vidA", "30", "dog", "train"]]


def test_fakenews_embed_pickle_as_jax(tmp_path):
    tsv = tmp_path / "train.tsv"
    tsv.write_text(
        "id\tclean_title\t6_way_label\tcomments\n"
        "a1\tBreaking news about cats\t0\tthis is clearly fake "
        "because reasons and more reasons\n"
        "a2\tAnother totally real story\t3\tno comment thread here\n")
    port, jax_dir = _both(tmp_path, lambda d: [
        "fakenews-embed", "--tsv", str(tsv), "--out", str(d / "df.pkl"),
        "--text-embedder", "", "--summarization-model", "", "--dialogue",
        "--embed-dim", "64", "--lead-tokens", "4"])
    got, want = _pickle(port / "df.pkl"), _pickle(jax_dir / "df.pkl")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value))
    assert _bytes(port / "df.pkl") == _bytes(jax_dir / "df.pkl")


def test_food101_tokens_and_split_as_jax(tmp_path):
    from PIL import Image

    from tests.test_spm import PIECES, serialize_model

    img_root = tmp_path / "imgs"
    img_root.mkdir()
    Image.new("RGB", (300, 200), (120, 30, 60)).save(img_root / "dish.jpg")
    lists = tmp_path / "lists"
    lists.mkdir()
    (lists / "list.tsv").write_text("dish.jpg\tthe cat, the dog!\n")
    (lists / "tokenizer.model").write_bytes(serialize_model(PIECES))
    port, jax_dir = _both(tmp_path, lambda d: [
        "food101-tokens", "--list-file", str(lists / "list.tsv"),
        "--image-root", str(img_root), "--out", str(d / "tokens"),
        "--tokenizer", "/nonexistent"])
    for name in ("dish_pixel_values.npy", "dish_input_ids.npy"):
        assert _bytes(port / "tokens" / name) == _bytes(
            jax_dir / "tokens" / name), name
    (tmp_path / "split.jsonl").write_text(
        '{"image": "a.jpg", "label": 3}\n{"image": "b.jpg", "label": 0}\n')
    (tmp_path / "split").mkdir()
    port, jax_dir = _both(tmp_path / "split", lambda d: [
        "food101-split", "--jsonl", str(tmp_path / "split.jsonl"),
        "--out", str(d / "my_train_food.txt")])
    assert _bytes(port / "my_train_food.txt") == _bytes(
        jax_dir / "my_train_food.txt")


def _shards(root):
    clips = [("vidA", 0, "dog", "train"), ("vidB", 3, "cat", "test"),
             ("vidC", 7, "dog", "train")]
    with open(root / "vggsound.csv", "w", newline="") as f:
        csv.writer(f).writerows(clips)
    names = [f"{c}_{str(s).zfill(6)}.mp4" for c, s, _, _ in clips]
    payloads = {n: bytes([i] * 64) for i, n in enumerate(names)}

    def add(tar, member_name, data):
        info = tarfile.TarInfo(member_name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    data = root / "vgg"
    data.mkdir()
    with tarfile.open(data / "vggsound_00.tar", "w") as t:
        add(t, f"scratch/{names[0]}", payloads[names[0]])
        add(t, f"scratch/{names[1]}", payloads[names[1]])
        add(t, "scratch/not_in_csv.mp4", b"xx")
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as t:
        add(t, f"nested/dir/{names[2]}", payloads[names[2]])
    with gzip.open(data / "vggsound_01.tar.gz", "wb") as f:
        f.write(buf.getvalue())
    return data


def test_vggsound_split_routes_shards_as_jax(tmp_path):
    trees = {}
    for side, tool in (("port", preprocess), ("jax", jax_preprocess)):
        (tmp_path / side).mkdir()
        data = _shards(tmp_path / side)
        tool.main(["vggsound-split", "--data-root", str(data), "--csv-file",
                   str(tmp_path / side / "vggsound.csv"), "--cleanup"])
        trees[side] = sorted(
            (os.path.relpath(os.path.join(d, n), data),
             _bytes(os.path.join(d, n)))
            for d, _, files in os.walk(data) for n in files)
    assert trees["port"] == trees["jax"]
    assert ("train/vidA_000000.mp4", bytes([0] * 64)) in trees["port"]
    assert not any(p.endswith("vggsound_01.tar") for p, _ in trees["port"])
