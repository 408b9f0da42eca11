"""The port's TensorBoard mirror (utils/logging.py) on the CPU.

CRC-32C and its mask against known answers and tensorboard's own
implementation; the TFRecord framing read back with every CRC checked;
the events decoded with tensorboard's protos (no TensorFlow) against the
cases of tests/test_tensorboard_logging.py; the three CLI verbs'
`--tensorboard`. The parity test against the JAX package's writer, which
imports TensorFlow (~15-40 s), runs with LDM_TEST_TB=1, as the JAX test
does."""

import json
import os
import pathlib
import struct

import numpy as np
import pytest
from tensorboard.compat.proto import event_pb2
from tensorboard.compat.tensorflow_stub import pywrap_tensorflow

from latent_diffusion_models_for_shape_sdfs_torch import cli
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger, crc32c, masked_crc32c, tfrecord)

needs_tb = pytest.mark.skipif(
    os.environ.get("LDM_TEST_TB") != "1",
    reason="set LDM_TEST_TB=1 (tensorflow import is ~15-40 s)")


@pytest.mark.parametrize("data,want", [
    (b"123456789", 0xE3069283), (b"", 0), (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43), (bytes(range(32)), 0x46DD794E)])
def test_crc32c_known_answers(data, want):
    """The CRC-32C check value and RFC 3720's test vectors; the mask
    rotates right by 15 and adds 0xa282ead8, as tensorboard's does."""
    assert crc32c(data) == want == pywrap_tensorflow.crc32c(data)
    rot = ((want >> 15) | (want << 17)) & 0xFFFFFFFF
    assert masked_crc32c(data) == (rot + 0xA282EAD8) & 0xFFFFFFFF
    assert masked_crc32c(data) == pywrap_tensorflow.masked_crc32c(data)


def read_records(path: pathlib.Path) -> list:
    """The data of every TFRecord in the file, each CRC checked."""
    data, out, off = path.read_bytes(), [], 0
    while off < len(data):
        head = data[off:off + 8]
        n, = struct.unpack("<Q", head)
        assert struct.unpack("<I", data[off + 8:off + 12])[0] == \
            masked_crc32c(head)
        body = data[off + 12:off + 12 + n]
        assert struct.unpack("<I", data[off + 12 + n:off + 16 + n])[0] == \
            masked_crc32c(body)
        out.append(body)
        off += 16 + n
    assert off == len(data)
    return out


def events(logdir: pathlib.Path) -> list:
    files = list(pathlib.Path(logdir).glob("events.out.tfevents.*"))
    assert len(files) == 1, files
    out = []
    for body in read_records(files[0]):
        e = event_pb2.Event()
        e.ParseFromString(body)
        out.append(e)
    return out


def scalars(evs) -> dict:
    """tag -> [(step, value)] of the scalar events."""
    seen: dict = {}
    for e in evs:
        for v in e.summary.value:
            assert v.metadata.plugin_data.plugin_name == "scalars"
            assert v.tensor.dtype == 1 and not v.tensor.tensor_shape.dim
            value, = struct.unpack("<f", v.tensor.tensor_content)
            seen.setdefault(v.tag, []).append((e.step, value))
    return seen


def test_framing_reads_back():
    rec = tfrecord(b"abc")
    assert rec[:8] == struct.pack("<Q", 3) and rec[12:15] == b"abc"
    assert len(rec) == 3 + 16


def test_metric_logger_mirrors_scalars(tmp_path):
    """The cases of the JAX package's test: tags, steps and values of the
    numeric fields, a text field skipped, a record without a step in the
    JSONL only; bools and ints mirrored as floats, as float() makes
    them."""
    log = MetricLogger(tmp_path / "m.jsonl", tensorboard=tmp_path / "tb")
    log.log("ad_epoch", epoch=0, loss_l1=0.5, lr=1e-3, note="text-ok")
    log.log("ad_epoch", epoch=1, loss_l1=0.25, lr=9e-4, flag=True, n=3)
    log.log("diff_chunk", step=200, loss=np.float32(0.125),
            grads=[1.0, 2.0])
    log.log("no_step_event", value=1.0)
    log.close()
    lines = (tmp_path / "m.jsonl").read_text().strip().splitlines()
    assert len(lines) == 4
    files = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert len(files) == 1 and files[0].name.endswith(".v2")
    evs = events(tmp_path / "tb")
    assert evs[0].file_version == "brain.Event:2"
    assert evs[0].wall_time == int(evs[0].wall_time) > 0
    seen = scalars(evs[1:])
    assert seen == {
        "ad_epoch/loss_l1": [(0, 0.5), (1, 0.25)],
        "ad_epoch/lr": [(0, np.float32(1e-3)), (1, np.float32(9e-4))],
        "ad_epoch/flag": [(1, 1.0)], "ad_epoch/n": [(1, 3.0)],
        "diff_chunk/loss": [(200, 0.125)]}
    assert len(evs) == 1 + 7


def test_cli_verbs_write_event_files(tmp_path):
    """train-ad, train-diff and train-encoder with --tensorboard write
    logs/tb/{ad,diff,enc}, one scalar per numeric field of every logged
    record with a step or epoch."""
    d = tmp_path / "exp"
    sets = ["ad.decoder.latent_size=8", "ad.decoder.hidden_dim=32",
            "ad.decoder.num_layers=2", "ad.decoder.latent_in=[]",
            "ad.decoder.use_dropout=false", "ad.scenes_per_batch=2",
            "ad.samples_per_scene=256", "ad.num_epochs=3",
            "diff.denoiser.latent_size=8", "diff.denoiser.hidden_dim=16",
            "diff.denoiser.num_blocks=1", "diff.denoiser.time_embed_dim=16",
            "diff.timesteps=20", "diff.batch_size=4", "diff.num_steps=40",
            "diff.scan_chunk=20", "diff.snapshot_every=40",
            "encoder.encoder.latent_size=8",
            "encoder.encoder.point_widths=[16]",
            "encoder.encoder.head_widths=[16]", "encoder.n_obs=64",
            "encoder.batch_scenes=2", "encoder.num_steps=20",
            "encoder.scan_chunk=10", "encoder.snapshot_every=20",
            "encoder.warmup_steps=2"]
    run = ["--device", "cpu"]
    cli.main([*run, "init-experiment", str(d), "--data", "analytic:sphere",
              "--scenes", "2", *(a for kv in sets for a in ("--set", kv))])
    for verb, log, tb in (("train-ad", "train_ad", "ad"),
                          ("train-diff", "train_diff", "diff"),
                          ("train-encoder", "train_enc", "enc")):
        cli.main([*run, verb, str(d), "--tensorboard"])
        recs = [json.loads(x) for x in (d / "logs" / f"{log}.jsonl")
                .read_text().splitlines()]
        want = {}
        for r in recs:
            fields = {k: v for k, v in r.items() if k not in ("event",
                                                              "time")}
            step = fields.get("step", fields.get("epoch"))
            if step is None:
                continue
            for k, v in fields.items():
                if k not in ("step", "epoch") and isinstance(
                        v, (int, float)):
                    want.setdefault(f"{r['event']}/{k}", []).append(
                        (int(step), float(np.float32(v))))
        got = scalars(events(d / "logs" / "tb" / tb)[1:])
        assert want and got.keys() == want.keys(), verb
        for tag, pts in want.items():
            assert [s for s, _ in got[tag]] == [s for s, _ in pts], tag
            np.testing.assert_array_equal([v for _, v in got[tag]],
                                          [v for _, v in pts])


@needs_tb
def test_events_equal_the_jax_writers(tmp_path):
    """The JAX package's MetricLogger (TensorFlow's writer) and the port's
    log the same records: their events agree field for field except
    wall_time, and the first event's source_metadata (TensorFlow names
    its writer there; the port writes none)."""
    from latent_diffusion_models_for_shape_sdfs_tpu.utils.logging import (
        MetricLogger as JaxLogger)
    logdirs = {}
    for name, cls in (("jax", JaxLogger), ("port", MetricLogger)):
        log = cls(tmp_path / name / "m.jsonl",
                  tensorboard=tmp_path / name / "tb")
        log.log("ad_epoch", epoch=0, loss_l1=0.5, lr=1e-3, note="text-ok")
        log.log("ad_epoch", epoch=1, loss_l1=0.25, lr=9e-4, flag=True, n=3)
        log.log("diff_chunk", step=1 << 40, loss=-1.5e-30)
        log.log("no_step_event", value=1.0)
        log.close()
        logdirs[name] = tmp_path / name / "tb"
    ref, ours = events(logdirs["jax"]), events(logdirs["port"])
    assert len(ref) == len(ours) == 8
    for a, b in zip(ref, ours):
        a.ClearField("wall_time")
        b.ClearField("wall_time")
        a.ClearField("source_metadata")
        assert a == b
        assert a.SerializeToString() == b.SerializeToString()
