"""Offline preprocessing CLI (port of the JAX package's
``tools/preprocess.py``): the reference's L0 layer as one tool, writing
the same files in the same layout.

Subcommands mirror the reference's run-once scripts (SURVEY §2.3 L0):

  cremad-audio    wav -> pickled (257, 1004) log-spectrograms, computed on
                  the card (``--device``, default cuda) in batches by
                  ops/spectrogram.cremad_spectrogram (replaces
                  cremad/video_preprocessing.py:111-130's librosa/scipy
                  host loop)
  ave-audio       AVE SE audio stage: Annotations.txt-windowed waveforms
                  (Audios/ wavs or in-process container decode) ->
                  Audio-1004-SE/<clip>.pkl spectrograms on the card
                  (ave/video_preprocessing.py extractWav_SE:244-279)
  ave-segments    Annotations.txt -> the clip,start,end csv that
                  video-frames / mp4-to-wav consume (--for frames pads
                  the inclusive tick window)
  video-frames    mp4 -> JPEG frames at a fixed FPS with a minimum count
                  (cremad/ave/vggsound video_preprocessing.py).  Backends:
                  ffmpeg when on PATH, else libav (native/libavdecode.so —
                  in-process FFmpeg libraries: H.264/HEVC/VP9/...), else
                  the native ISO-BMFF demuxer (native/mp4_demux.cpp —
                  MJPEG samples written verbatim)
  mp4-to-wav      mp4 -> 16 kHz mono wav (ave/vggsound mp4_to_wav.py).
                  Same backend chain (libav: AAC/MP3/Opus/...; native
                  path extracts PCM tracks)
  food101-tokens  image+text -> SigLIP input_ids / pixel_values .npy pairs
                  (food101/extract_token.py:45-69; HF tokenizer gated,
                  pixel path always available via PIL)
  vggsound-split  extract vggsound_NN.tar[.gz] shards and route clips to
                  train/test per the csv (make_train_test_split.py, stdlib
                  tarfile/gzip)
  codec-census    aggregate per-codec file counts for a video dir with a
                  decodability verdict per backend (run BEFORE a big
                  download — docs/DATASETS.md matrix)
  check-frames    report clip dirs with fewer than N frames
                  (vggsound/check_frames.py:4-22)
  fix-missing     reconcile a csv list against extracted files
                  (vggsound/fix_missing.py:1-30)

Usage: python -m multimodal_clinical_tpu_torch.tools.preprocess <subcommand>
[options].  Only cremad-audio and ave-audio use the device; the rest are
host code over the port's ``utils/native.py`` and ``utils/avdecode.py``.
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import re
import shutil
import subprocess
import wave

import numpy as np

TARGET_SR = 16000


def _pick_backend(requested: str) -> str:
    """Backend chain: 'ffmpeg' when a binary is on PATH, else 'libav'
    when native/libavdecode.so loads (the FFmpeg *libraries* in-process —
    H.264/HEVC/VP9/AAC/MP3/Opus etc., utils/avdecode.py), else the
    zero-dependency ISO-BMFF demuxer (native/mp4_demux.cpp: MJPEG video +
    PCM audio only, fails with a codec-naming error otherwise)."""
    if requested != "auto":
        return requested
    if shutil.which("ffmpeg") is not None:
        return "ffmpeg"
    from ..utils import avdecode

    return "libav" if avdecode.available() else "native"


_JPEG_CODECS = {"jpeg", "mjpa", "mjpb", "MJPG", "mjpg"}


def _codec_census(video_dir: str, exts) -> tuple:
    """Aggregate container probe over ``video_dir``: {(video_codec,
    audio_codec): count}, unreadable count, total.  Header-only reads via
    the native demuxer — cheap even on a full VGGSound download."""
    from ..utils.native import Mp4File

    census: dict = {}
    unreadable = 0
    files = sorted(f for f in os.listdir(video_dir) if f.endswith(tuple(exts)))
    for name in files:
        try:
            with Mp4File(os.path.join(video_dir, name)) as m:
                video = [t["codec"] for t in m.tracks
                         if t["handler"] == "vide"]
                audio = [t["codec"] for t in m.tracks
                         if t["handler"] == "soun"]
        except Exception:  # non-ISO-BMFF container (.avi/.flv) or corrupt
            unreadable += 1
            continue
        key = (video[0] if video else "-", audio[0] if audio else "-")
        census[key] = census.get(key, 0) + 1
    return census, unreadable, len(files)


def _print_census(video_dir: str, exts, need: str, backend: str) -> None:
    """Per-codec file counts + native-decodability verdict, printed BEFORE
    any per-file work so the H.264/AAC-needs-ffmpeg limitation is
    discoverable up front (not 338 GB into a VGGSound download).
    ``need`` is 'video' (frame extraction) or 'audio' (wav extraction)."""
    from ..utils import native as native_lib

    if not native_lib.available():
        return
    try:
        census, unreadable, total = _codec_census(video_dir, exts)
    except Exception:
        return
    from ..utils import avdecode

    libav = avdecode.available()
    print(f"[census] {total} files probed in {video_dir}"
          + (f" ({unreadable} not ISO-BMFF/unreadable)" if unreadable else ""))
    # "will fail" is judged against the SELECTED backend: files the native
    # demuxer can't touch still fail under --backend native even when the
    # verdict column says a libav fallback could have decoded them
    # non-ISO-BMFF/unreadable files only doom the native demuxer backend
    # (libav and ffmpeg read most container formats)
    unsupported = unreadable if backend == "native" else 0
    for (v, a), n in sorted(census.items(), key=lambda kv: -kv[1]):
        codec = v if need == "video" else a
        native_ok = (v in _JPEG_CODECS if need == "video"
                     else a in native_lib.PCM_MP4_CODECS)
        libav_ok = libav and avdecode.can_decode_fourcc(codec)
        if native_ok:
            verdict = "native-ok"
        elif libav_ok:
            verdict = "libav-ok"
        else:
            verdict = "needs ffmpeg"
        will_fail = ((backend == "native" and not native_ok)
                     or (backend == "libav" and not libav_ok))
        if will_fail:
            unsupported += n
        print(f"[census]   video={v!r} audio={a!r}: {n} ({verdict})")
    if unsupported and backend in ("native", "libav"):
        print(f"[census] WARNING: {unsupported}/{total} files cannot be "
              f"decoded for {need} extraction by the selected {backend} "
              "backend — they will fail (supported-codec matrix: "
              "docs/DATASETS.md)")


def _native_video_frames(src: str, out_dir: str, fps: float, seg) -> int:
    """MJPEG-in-MP4 frame extraction on the fps grid (each container
    sample IS a JPEG; written verbatim, no re-encode)."""
    from ..utils.native import Mp4File

    with Mp4File(src) as m:
        vid = [i for i, t in enumerate(m.tracks) if t["handler"] == "vide"]
        if not vid:
            raise RuntimeError(f"{src}: no video track")
        t = vid[0]
        codec = m.tracks[t]["codec"]
        if codec not in _JPEG_CODECS:
            raise RuntimeError(
                f"{src}: video codec {codec!r} needs ffmpeg (native path "
                "decodes MJPEG only)")
        times = m.sample_times(t)
        start = seg[0] if seg else 0.0
        # end at the TRACK duration like ffmpeg's fps filter (the last
        # sample's decode time ends the grid a frame-duration early);
        # duration==0 (malformed mdhd) falls back to the old estimate
        tr = m.tracks[t]
        duration = tr["duration"] / max(tr["timescale"], 1)
        if seg:
            end = seg[1]
        elif duration > 0:
            end = duration
        else:
            end = float(times[-1]) + 1.0 / fps
        # ffmpeg -vf fps semantics: one frame per 1/fps tick, nearest
        # preceding sample
        n_out = 0
        tick = start
        while tick < end:
            i = int(np.searchsorted(times, tick + 1e-9, side="right")) - 1
            i = max(i, 0)
            n_out += 1
            with open(os.path.join(out_dir, f"frame_{n_out:05d}.jpg"),
                      "wb") as f:
                f.write(m.read_sample(t, i))
            tick = start + n_out / fps
        return n_out


def _libav_video_frames(src: str, out_dir: str, fps: float, seg) -> int:
    """Any-codec frame extraction via native/libavdecode.so (H.264/HEVC/
    VP9/... — the codecs the reference decodes through OpenCV/ffmpeg,
    cremad/video_preprocessing.py:36-76).  Same fps tick grid as the
    MJPEG path; frames are decoded to RGB and saved as JPEG via PIL
    (ffmpeg's -q:v 2 is roughly quality 93)."""
    from PIL import Image

    from ..utils import avdecode

    start = seg[0] if seg else 0.0
    end = seg[1] if seg else None
    n_out = 0
    for frame, _tick in avdecode.decode_frames_at_fps(
            src, fps, start=start, end=end):
        n_out += 1
        Image.fromarray(frame).save(
            os.path.join(out_dir, f"frame_{n_out:05d}.jpg"), quality=93)
    return n_out


def _libav_mp4_to_wav(src: str, dst: str, seg) -> None:
    """Any-codec audio extraction -> mono 16 kHz wav via libavdecode
    (AAC/MP3/Opus/... — the reference's ffmpeg call,
    vggsound/mp4_to_wav.py:26-44).  swresample does mixdown + rate
    conversion in-process."""
    from ..utils import avdecode

    data, sr = avdecode.read_audio_mono(src, TARGET_SR)
    if seg:
        i0 = int(max(seg[0], 0) * sr)
        i1 = int(seg[1] * sr)
        data = data[i0:i1]
    pcm = np.clip(data * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(dst, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(TARGET_SR)
        w.writeframes(pcm.tobytes())


def _native_mp4_to_wav(src: str, dst: str, seg) -> None:
    """PCM-in-MP4 audio extraction -> mono 16 kHz wav (the reference's
    ffmpeg call: vggsound/mp4_to_wav.py:26-44).  Decode/mixdown lives in
    utils/native.read_mp4_pcm_mono; ValueError from it names the codec
    and the ffmpeg requirement."""
    from ..utils.native import (
        read_mp4_pcm_mono, resample_linear,
    )

    try:
        data, sr = read_mp4_pcm_mono(src)
    except ValueError as exc:
        raise RuntimeError(str(exc)) from exc
    if seg:
        i0 = int(max(seg[0], 0) * sr)
        i1 = int(seg[1] * sr)
        data = data[i0:i1]
    data = resample_linear(data, sr, TARGET_SR)
    pcm = np.clip(data * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(dst, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(TARGET_SR)
        w.writeframes(pcm.tobytes())


def _read_wav_mono(path: str) -> np.ndarray:
    from ..utils.native import pcm16_to_float_mono

    with wave.open(path, "rb") as w:
        channels = w.getnchannels()
        sr = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
    out = pcm16_to_float_mono(data, channels)
    if out is None:
        if channels > 1:
            data = data.reshape(-1, channels).mean(axis=1)
        out = (data / 32768.0).astype(np.float32)
    from ..utils.native import resample_linear

    return resample_linear(out, sr, TARGET_SR)


def _write_spectrograms(waves, names, out_dir: str, device) -> None:
    """One batch: the waveforms' ``cremad_spectrogram`` on ``device``, each
    pickled as a float32 numpy array to ``<out_dir>/<name>.pkl``.  The
    spectrogram is per clip, so a short tail batch needs no padding."""
    import torch

    from ..ops.spectrogram import cremad_spectrogram

    specs = cremad_spectrogram(
        torch.from_numpy(np.stack(waves)).to(device)).cpu().numpy()
    for name, spec in zip(names, specs):
        with open(os.path.join(out_dir, name + ".pkl"), "wb") as f:
            pickle.dump(spec.astype(np.float32), f)


def cmd_cremad_audio(args):
    """wav dir -> per-clip pickled log-spectrograms, computed on the device
    in batches (tile to >= 10x length, clip to [-1, 1], spectrogram,
    standardize — cremad/video_preprocessing.py:111-130 semantics)."""
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    wavs = sorted(f for f in os.listdir(args.wav_dir) if f.endswith(".wav"))
    batch, names = [], []

    def flush():
        if batch:
            _write_spectrograms(batch, names, args.out, device)
        batch.clear()
        names.clear()

    # the SAME host half the adapter's zero-offline-stage streaming mode
    # uses (benchmarks/cremad.py), so the pickles and the on-device path
    # stay bit-comparable by construction
    from ..benchmarks.cremad import _tile_clip_waveform

    for name in wavs:
        wav = _read_wav_mono(os.path.join(args.wav_dir, name))
        if len(wav) == 0:
            raise ValueError(
                f"{os.path.join(args.wav_dir, name)}: empty wav (corrupt "
                f"or zero-length decode)")
        batch.append(_tile_clip_waveform(wav, name))
        names.append(os.path.splitext(name)[0])
        if len(batch) == args.batch_size:
            flush()
    flush()
    print(f"wrote {len(wavs)} spectrograms to {args.out}")


def cmd_ave_audio(args):
    """AVE offline audio stage (ave/video_preprocessing.py extractWav_SE:
    244-279): per-clip Annotations.txt [start, end) s windows tiled to
    10 s -> (257, 1004) log-spectrogram pickles in the ``Audio-1004-SE``
    layout, spectrograms computed on the device in batches.  Waveforms come
    from Audios/<clip>.wav when the mp4-to-wav stage ran, else are
    decoded in-process from AVE/<clip>.mp4 — via the SAME loader methods
    the adapter's zero-offline-stage streaming mode uses
    (benchmarks/ave.py), so pickles and the streamed path stay
    bit-comparable by construction."""
    from ..benchmarks.ave import AveDiskDataset, _read_annotations
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    segments = _read_annotations(args.data_dir)
    if not segments:
        raise FileNotFoundError(
            f"{os.path.join(args.data_dir, 'Annotations.txt')}: missing "
            "or empty — the SE pipeline needs per-clip start/end rows")
    out = args.out or os.path.join(args.data_dir,
                                   AveDiskDataset.audio_pkl_dir)
    os.makedirs(out, exist_ok=True)
    ds = AveDiskDataset(args.data_dir, [], train=False,
                        audio_mode="stream", segments=segments)
    batch, names = [], []

    def flush():
        if batch:
            _write_spectrograms(batch, names, out, device)
        batch.clear()
        names.clear()

    done = 0
    for clip in sorted(segments):
        try:
            wav = ds._load_audio_waveform(clip)
        except FileNotFoundError:
            print(f"[ave-audio] skip {clip}: no Audios/{clip}.wav and "
                  f"no decodable AVE/{clip} container")
            continue
        except (ValueError, RuntimeError) as exc:
            # empty Annotations.txt segment (the reference's own FIXME at
            # ave/video_preprocessing.py:145) or a corrupt container decode
            # — skip per-clip rather than abort the whole offline stage
            print(f"[ave-audio] skip {clip}: {exc}")
            continue
        batch.append(wav)
        names.append(clip)
        done += 1
        if len(batch) == args.batch_size:
            flush()
    flush()
    print(f"wrote {done} spectrograms to {out}")


def cmd_ave_segments(args):
    """Annotations.txt -> the clip,start,end csv the generic
    video-frames / mp4-to-wav subcommands consume.  ``--for frames``
    widens end by +1 s: the reference saves 1 FPS ticks with num_count
    in [start, end] INCLUSIVE (ave/video_preprocessing.py:121-126) while
    the csv consumers cut [start, end); ``--for audio`` keeps
    [start, end) (extractWav_SE:254-257)."""
    from ..benchmarks.ave import _read_annotations

    segments = _read_annotations(args.data_dir)
    if not segments:
        raise FileNotFoundError(
            f"{os.path.join(args.data_dir, 'Annotations.txt')}: missing "
            "or empty")
    pad = 1 if args.target == "frames" else 0
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        for clip, (start, end) in sorted(segments.items()):
            w.writerow([clip, start, end + pad])
    print(f"wrote {len(segments)} segment rows ({args.target} windows) "
          f"to {args.out}")


def _resolve_jobs(args) -> int:
    """--jobs 0 (default) = one worker per host core.  The decode work
    releases the GIL (libav/native via ctypes, ffmpeg as a subprocess),
    so threads scale on real multi-core hosts — the reference's
    single-threaded ffmpeg loop takes ~7 h over VGGSound
    (vggsound/DATASET.md:1-24)."""
    jobs = int(getattr(args, "jobs", 0) or 0)
    return jobs if jobs > 0 else max(1, os.cpu_count() or 1)


def _map_files(fn, items, jobs: int) -> None:
    """Apply fn to every item, across a thread pool when jobs > 1.
    Per-clip outputs are independent files/dirs, so completion order
    doesn't matter; the first worker exception propagates."""
    if jobs <= 1 or len(items) <= 1:
        for item in items:
            fn(item)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=jobs) as ex:
        for _ in ex.map(fn, items):
            pass


def _load_segments(path):
    """clip_id,start_sec,end_sec csv -> dict (the AVE SE-aware pipeline,
    ave/video_preprocessing.py video2frame_update_SE / extractWav_SE)."""
    segments = {}
    if not path:
        return segments
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 3:
                segments[row[0]] = (float(row[1]), float(row[2]))
    return segments


def cmd_video_frames(args):
    backend = _pick_backend(getattr(args, "backend", "auto"))
    os.makedirs(args.out, exist_ok=True)
    segments = _load_segments(getattr(args, "segments", None))
    _print_census(args.video_dir, (".mp4", ".flv", ".avi", ".mov"),
                  "video", backend)
    videos = sorted(f for f in os.listdir(args.video_dir)
                    if f.endswith((".mp4", ".flv", ".avi", ".mov")))

    def _one(name: str) -> None:
        clip = os.path.splitext(name)[0]
        out_dir = os.path.join(args.out, clip)
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(args.video_dir, name)
        if backend in ("native", "libav"):
            seg = segments.get(clip)
            if backend == "native":
                _native_video_frames(src, out_dir, args.fps, seg)
            else:
                _libav_video_frames(src, out_dir, args.fps, seg)
        else:
            seg = []
            if clip in segments:
                start, end = segments[clip]
                seg = ["-ss", str(start), "-t", str(max(end - start, 0.1))]
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", *seg, "-i", src,
                 "-vf", f"fps={args.fps}", "-q:v", "2",
                 os.path.join(out_dir, "frame_%05d.jpg")],
                check=True,
            )
        # minimum-frame guarantee (video_preprocessing.py min 3 frames)
        frames = sorted(os.listdir(out_dir))
        while 0 < len(frames) < args.min_frames:
            shutil.copy(os.path.join(out_dir, frames[-1]),
                        os.path.join(out_dir,
                                     f"frame_{len(frames) + 1:05d}.jpg"))
            frames = sorted(os.listdir(out_dir))

    _map_files(_one, videos, _resolve_jobs(args))
    print(f"extracted frames for {len(videos)} videos into {args.out}")


def cmd_mp4_to_wav(args):
    backend = _pick_backend(getattr(args, "backend", "auto"))
    os.makedirs(args.out, exist_ok=True)
    segments = _load_segments(getattr(args, "segments", None))
    # .flv included: raw Crema-D ships VideoFlash containers (the census's
    # native prober reports them as unreadable; libav/ffmpeg decode them)
    _print_census(args.video_dir, (".mp4", ".mov", ".flv"), "audio", backend)
    videos = sorted(f for f in os.listdir(args.video_dir)
                    if f.endswith((".mp4", ".mov", ".flv")))

    def _one(name: str) -> None:
        clip = os.path.splitext(name)[0]
        src = os.path.join(args.video_dir, name)
        if backend == "native":
            _native_mp4_to_wav(src, os.path.join(args.out, clip + ".wav"),
                               segments.get(clip))
            return
        if backend == "libav":
            _libav_mp4_to_wav(src, os.path.join(args.out, clip + ".wav"),
                              segments.get(clip))
            return
        seg = []
        if clip in segments:
            start, end = segments[clip]
            seg = ["-ss", str(start), "-t", str(max(end - start, 0.1))]
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", *seg, "-i", src, "-ac", "1",
             "-ar", str(TARGET_SR),
             os.path.join(args.out, clip + ".wav")],
            check=True,
        )

    _map_files(_one, videos, _resolve_jobs(args))
    print(f"extracted audio for {len(videos)} videos into {args.out}")


def cmd_food101_tokens(args):
    """text+image -> SigLIP input_ids / pixel_values .npy pairs.

    Pixel path (resize 224, rescale, normalize 0.5/0.5 — the SigLIP
    processor's image transform) always works; token ids come from the
    NATIVE SentencePiece unigram encoder (data/spm.py) whenever a local
    ``tokenizer.model``/``spiece.model`` exists (``--spm-model`` or next
    to ``--list-file``) — reproducible without ``transformers``; the HF
    tokenizer is only a fallback when no .model file is given but a full
    local HF snapshot is (zero-egress gate either way)."""
    from PIL import Image

    os.makedirs(args.out, exist_ok=True)
    tokenizer = None
    spm_model = None
    spm_path = getattr(args, "spm_model", None)
    if not spm_path:
        for name in ("tokenizer.model", "spiece.model"):
            cand = os.path.join(os.path.dirname(os.path.abspath(
                args.list_file)), name)
            if os.path.isfile(cand):
                spm_path = cand
                break
    if spm_path and os.path.isfile(spm_path):
        from ..data.spm import SentencePieceModel

        spm_model = SentencePieceModel.from_file(spm_path)
        print(f"[food101-tokens] native SentencePiece encoder from "
              f"{spm_path}")
    else:
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(
                args.tokenizer, local_files_only=True)
        except Exception as exc:
            print(f"[food101-tokens] no tokenizer.model and HF tokenizer "
                  f"unavailable ({exc}); writing pixel tensors only")

    count = 0
    with open(args.list_file) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            img_path, text = parts[0], parts[1]
            stem = os.path.splitext(os.path.basename(img_path))[0]
            img = Image.open(os.path.join(args.image_root, img_path)
                             ).convert("RGB").resize((224, 224))
            px = (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5
            np.save(os.path.join(args.out, stem + "_pixel_values.npy"),
                    px.transpose(2, 0, 1)[None])  # reference stores CHW
            if spm_model is not None:
                np.save(os.path.join(args.out, stem + "_input_ids.npy"),
                        spm_model.encode_siglip(text, max_len=64))
            elif tokenizer is not None:
                ids = tokenizer(text, padding="max_length", truncation=True,
                                max_length=64)["input_ids"]
                np.save(os.path.join(args.out, stem + "_input_ids.npy"),
                        np.asarray(ids, np.int32))
            count += 1
    print(f"wrote {count} samples to {args.out}")


def cmd_food101_split(args):
    """jsonl -> my_{split}_food.txt path/label lists
    (food101/gen_food_txt.py:1-23 equivalent)."""
    import json

    count = 0
    with open(args.jsonl) as fin, open(args.out, "w") as fout:
        for line in fin:
            rec = json.loads(line)
            fout.write(f"{rec['image']} {int(rec['label'])}\n")
            count += 1
    print(f"wrote {count} entries to {args.out}")


def cmd_fakenews_embed(args):
    """Fakeddit TSV -> preprocessed dataframe pickle: cleaned text, text
    embeddings, optional summarized dialogue.

    The reference's fakenews/data_preprocessing.py (broken as shipped:
    line 54 is the literal ``text_embedder = `` syntax error) embeds
    ``clean_title`` with a sentence-transformers model
    (preprocess.yaml ``text_embedder: all-distilroberta-v1``) and
    summarizes comment threads with a seq2seq model
    (``dialogue_summarization_model: sshleifer/distilbart-cnn-12-6``).
    Both are config-gated here (zero-egress image): when local weights are
    unavailable the embedder falls back to a deterministic hashed
    bag-of-words embedding and the summarizer to lead-N extraction, so the
    downstream pipeline shape is always exercised.  Output: a pickle of
    {"id", "text", "embedding" (N, D), "label"[, "dialogue_summary",
    "dialogue_embedding" (N, D)]} — the dialogue summaries are embedded
    with the same text embedder, feeding the embed-fusion variant's
    dialogue tower (fakenews/model.py:243-244 consumes a 768-d dialogue
    embedding).
    """
    import csv as _csv
    import pickle
    import zlib

    embedder = None
    if args.text_embedder:
        try:
            from sentence_transformers import SentenceTransformer

            embedder = SentenceTransformer(args.text_embedder)
        except Exception as exc:
            print(f"[fakenews-embed] embedder unavailable ({exc}); "
                  "hashed bag-of-words fallback")
    summarizer = None
    if args.dialogue and args.summarization_model:
        try:
            from transformers import pipeline

            summarizer = pipeline("summarization",
                                  model=args.summarization_model)
        except Exception as exc:
            print(f"[fakenews-embed] summarizer unavailable ({exc}); "
                  "lead-{n} extraction fallback".format(n=args.lead_tokens))

    def hash_embed(text, dim=args.embed_dim):
        vec = np.zeros(dim, np.float32)
        for tok in text.lower().split():
            h = zlib.crc32(tok.encode())
            vec[h % dim] += 1.0 if (h >> 16) & 1 else -1.0
        norm = np.linalg.norm(vec)
        return vec / norm if norm > 0 else vec

    ids, texts, labels, summaries = [], [], [], []
    with open(args.tsv) as f:
        for row in _csv.DictReader(f, delimiter="\t"):
            ids.append(row.get("id", str(len(ids))))
            texts.append(row.get("clean_title", ""))
            labels.append(int(row.get("6_way_label", 0)))
            if args.dialogue:
                comments = row.get("comments", "") or row.get("dialogue", "")
                if summarizer is not None and comments:
                    summaries.append(summarizer(
                        comments, truncation=True)[0]["summary_text"])
                else:
                    summaries.append(" ".join(
                        comments.split()[: args.lead_tokens]))
    if embedder is not None:
        emb = np.asarray(embedder.encode(texts), np.float32)
    else:
        emb = np.stack([hash_embed(t) for t in texts]) if texts else \
            np.zeros((0, args.embed_dim), np.float32)
    out = {"id": ids, "text": texts, "embedding": emb,
           "label": np.asarray(labels, np.int32)}
    if args.dialogue:
        out["dialogue_summary"] = summaries
        if embedder is not None:
            out["dialogue_embedding"] = np.asarray(
                embedder.encode(summaries), np.float32)
        else:
            out["dialogue_embedding"] = (
                np.stack([hash_embed(s) for s in summaries]) if summaries
                else np.zeros((0, args.embed_dim), np.float32))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {len(ids)} samples (embedding dim {emb.shape[-1]}) "
          f"to {args.out}")


def cmd_vggsound_split(args):
    """Extract vggsound_NN.tar.gz shards and route each clip into
    data_root/{train,test}/ per the csv's split column
    (vggsound/make_train_test_split.py:26-70, stdlib tarfile+gzip instead
    of pandas+pigz; pigz is used when on PATH).  Idempotent: already-
    routed clips are skipped."""
    import gzip
    import tarfile

    mapping = {}
    with open(args.csv_file) as f:
        for row in csv.reader(f):
            if len(row) >= 4:
                name = f"{row[0]}_{str(row[1]).zfill(6)}.mp4"
                mapping[name] = row[3].strip()
    for split in ("train", "test"):
        os.makedirs(os.path.join(args.data_root, split), exist_ok=True)

    shards = sorted(n for n in os.listdir(args.data_root)
                    if re.fullmatch(r"vggsound_\d+\.tar(\.gz)?", n))
    routed = skipped = 0
    for shard in shards:
        path = os.path.join(args.data_root, shard)
        if shard.endswith(".gz"):
            tar_path = path[:-3]
            if not os.path.exists(tar_path):
                # decompress via a temp name + rename so an interrupted
                # run can't leave a truncated .tar that later runs trust
                tmp_tar = tar_path + ".tmp"
                if shutil.which("pigz"):
                    with open(tmp_tar, "wb") as dst:
                        subprocess.run(["pigz", "-d", "-c", path],
                                       check=True, stdout=dst)
                else:
                    with gzip.open(path, "rb") as src, \
                            open(tmp_tar, "wb") as dst:
                        shutil.copyfileobj(src, dst, 1 << 20)
                os.replace(tmp_tar, tar_path)
        else:
            tar_path = path
        with tarfile.open(tar_path, "r") as tar:
            for member in tar:
                if not member.isfile():
                    continue
                file_name = member.name.split("/")[-1]
                split = mapping.get(file_name)
                if split is None:
                    continue  # not in the csv (e.g. scratch dirs)
                dst = os.path.join(args.data_root, split, file_name)
                if os.path.exists(dst):
                    skipped += 1
                    continue
                # temp name + atomic rename: a clip interrupted mid-copy
                # must not satisfy the idempotency check on the next run
                src = tar.extractfile(member)
                tmp = dst + ".tmp"
                with open(tmp, "wb") as out:
                    shutil.copyfileobj(src, out, 1 << 20)
                os.replace(tmp, dst)
                routed += 1
        if args.cleanup and tar_path != path:
            os.remove(tar_path)
    print(f"routed {routed} clips ({skipped} already present) from "
          f"{len(shards)} shards into {args.data_root}/{{train,test}}")


def cmd_check_frames(args):
    bad = []
    for clip in sorted(os.listdir(args.frames_root)):
        d = os.path.join(args.frames_root, clip)
        if os.path.isdir(d) and len(os.listdir(d)) < args.min_frames:
            bad.append(clip)
    for clip in bad:
        print(clip)
    print(f"{len(bad)} clip dirs with < {args.min_frames} frames")


def cmd_fix_missing(args):
    with open(args.csv_file) as f:
        rows = list(csv.reader(f))

    def exists(r):
        # vggsound.csv rows (numeric start in col 1) name files
        # <ytid>_<start zfill(6)><suffix> — reference fix_missing.py:17;
        # other csvs (no numeric col) use the bare id
        stems = [r[0]]
        if len(r) >= 2 and str(r[1]).isdigit():
            stems.insert(0, f"{r[0]}_{str(r[1]).zfill(6)}")
        return any(os.path.exists(os.path.join(args.data_root, s + args.suffix))
                   for s in stems)

    kept = [r for r in rows if exists(r)]
    with open(args.out, "w", newline="") as f:
        csv.writer(f).writerows(kept)
    print(f"kept {len(kept)}/{len(rows)} rows -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("cremad-audio")
    s.add_argument("--wav-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_cremad_audio)

    s = sub.add_parser("ave-audio")
    s.add_argument("--data-dir", required=True,
                   help="AVE dataset root with Annotations.txt + "
                        "Audios/ wavs and/or AVE/ containers")
    s.add_argument("--out", default=None,
                   help="default <data-dir>/Audio-1004-SE")
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_ave_audio)

    s = sub.add_parser("ave-segments")
    s.add_argument("--data-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--for", dest="target", choices=("frames", "audio"),
                   default="frames",
                   help="frames: inclusive-tick window [start, end+1); "
                        "audio: extractWav_SE's [start, end)")
    s.set_defaults(fn=cmd_ave_segments)

    s = sub.add_parser("video-frames")
    s.add_argument("--video-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--fps", type=float, default=1.0)
    s.add_argument("--min-frames", type=int, default=3)
    s.add_argument("--segments", default=None,
                   help="clip,start,end csv for segment-aware extraction "
                        "(AVE SE pipeline)")
    s.add_argument("--backend",
                   choices=("auto", "ffmpeg", "libav", "native"),
                   default="auto",
                   help="auto: ffmpeg when on PATH, else libav "
                        "(in-process FFmpeg libraries: H.264/HEVC/VP9/"
                        "...), else the native demuxer (MJPEG only)")
    s.add_argument("--jobs", type=int, default=0,
                   help="parallel extraction workers (0 = host cores; "
                        "decode releases the GIL)")
    s.set_defaults(fn=cmd_video_frames)

    s = sub.add_parser("mp4-to-wav")
    s.add_argument("--video-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--segments", default=None,
                   help="clip,start,end csv (AVE extractWav_SE)")
    s.add_argument("--backend",
                   choices=("auto", "ffmpeg", "libav", "native"),
                   default="auto",
                   help="auto: ffmpeg when on PATH, else the native "
                        "demuxer (PCM only)")
    s.add_argument("--jobs", type=int, default=0,
                   help="parallel extraction workers (0 = host cores; "
                        "decode releases the GIL)")
    s.set_defaults(fn=cmd_mp4_to_wav)

    s = sub.add_parser("food101-tokens")
    s.add_argument("--list-file", required=True,
                   help="tsv: image_path<TAB>text")
    s.add_argument("--image-root", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--tokenizer", default="google/siglip-base-patch16-224")
    s.add_argument("--spm-model", default=None,
                   help="local tokenizer.model/spiece.model for the native "
                        "SentencePiece encoder (data/spm.py); auto-detected "
                        "next to --list-file when omitted")
    s.set_defaults(fn=cmd_food101_tokens)

    s = sub.add_parser("food101-split")
    s.add_argument("--jsonl", required=True,
                   help="records with 'image' and 'label' fields")
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_food101_split)

    s = sub.add_parser("vggsound-split")
    s.add_argument("--data-root", required=True,
                   help="dir holding vggsound_NN.tar[.gz] shards")
    s.add_argument("--csv-file", required=True,
                   help="vggsound.csv (clip, start, class, split)")
    s.add_argument("--cleanup", action="store_true",
                   help="remove decompressed .tar after routing")
    s.set_defaults(fn=cmd_vggsound_split)

    s = sub.add_parser("codec-census")
    s.add_argument("--video-dir", required=True)
    s.set_defaults(fn=lambda a: (
        _print_census(a.video_dir, (".mp4", ".mov", ".flv", ".avi"),
                      "video", _pick_backend("auto")),
        _print_census(a.video_dir, (".mp4", ".mov", ".flv"), "audio",
                      _pick_backend("auto")),
    ))

    s = sub.add_parser("check-frames")
    s.add_argument("--frames-root", required=True)
    s.add_argument("--min-frames", type=int, default=6)
    s.set_defaults(fn=cmd_check_frames)

    s = sub.add_parser("fix-missing")
    s.add_argument("--csv-file", required=True)
    s.add_argument("--data-root", required=True)
    s.add_argument("--suffix", default=".wav")
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_fix_missing)

    s = sub.add_parser("fakenews-embed")
    s.add_argument("--tsv", required=True)
    s.add_argument("--out", required=True)
    # preprocess.yaml keys (fakenews/preprocess.yaml:7-8); empty string
    # disables the model and uses the offline fallback
    s.add_argument("--text-embedder", default="all-distilroberta-v1")
    s.add_argument("--summarization-model",
                   default="sshleifer/distilbart-cnn-12-6")
    s.add_argument("--dialogue", action="store_true")
    s.add_argument("--embed-dim", type=int, default=768)
    s.add_argument("--lead-tokens", type=int, default=48)
    s.set_defaults(fn=cmd_fakenews_embed)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
