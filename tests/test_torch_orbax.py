"""Reading the JAX trainer's Orbax checkpoints in the port
(``compat/ocdbt.py``, ``compat/orbax.py``, ``training/checkpoint.py``,
``compat/torch_export.py``), held against the JAX package on the CPU.

The port's reader returns every array bit-equal to
``vqa_tpu.training.checkpoint.load_checkpoint`` on: a narrow trainer tree
(params, batch_stats, opt_state, step) written by ``save_checkpoint``; a
full-width ``ModelConfig()`` tree; arrays of several chunks, edge chunks,
missing chunks and bfloat16 arrays; and the plain-directory layout. A
damaged node or frame raises. The port's engine, loaded from the JAX
directory, gives the JAX engine's probabilities and logits; the port's
exporter writes the JAX exporter's ``.pth``; the evaluator CLI reads the
directory. The committed fixture (``tests/fixtures/orbax_narrow``) still
restores, with orbax, to the digests it carries.
"""

import base64
import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from vqa_tpu.compat import torch_export as jax_export
from vqa_tpu.models import create_vqa_model as jax_create_model
from vqa_tpu.models import forward_logits as jax_forward_logits
from vqa_tpu.models import init_vqa_model
from vqa_tpu.serving.engine import VQAInference as JaxInference
from vqa_tpu.training import checkpoint as jax_ckpt
from vqa_tpu.training.train import TrainState, make_optimizer
from vqa_tpu.utils.config import InferenceConfig as JaxInferenceConfig
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import TrainingConfig
from vqa_tpu_torch.compat import ocdbt, orbax
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.training import evaluate
from vqa_tpu_torch.utils.config import InferenceConfig
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax_narrow")
TINY = dict(vocab_size=50, embed_dim=16, num_answers=8, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=32, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=1)
META = {"epoch": 3, "best_val_accuracy": 0.375,
        "metrics_history": {"train_loss": [2.1, 1.9], "val_accuracy": [0.25, 0.375]}}


def _flat(tree, path=()):
    """(key path, leaf) of a tree of dicts and lists, sequence indices as
    strings."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


def _assert_bit_equal(ours, theirs):
    a, b = dict(_flat(ours)), dict(_flat(theirs))
    assert a.keys() == b.keys()
    for path, want in b.items():
        got = a[path]
        if want is None or isinstance(want, (int, float)):
            assert type(got) is type(want) and got == want, path
            continue
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            assert orbax.is_bfloat16(got), path
            want = want.view(np.uint16)
        else:
            assert got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path


def _random_like(tree, seed):
    """Seeded values of each array leaf's shape and dtype (no compile)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return rng.standard_normal(x.shape).astype(x.dtype)
        return rng.integers(0, 100, x.shape).astype(x.dtype)

    return jax.tree_util.tree_map(fill, tree)


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """A narrow trainer tree saved by the JAX package's ``save_checkpoint``,
    with a tokenizer and an answer vocabulary beside it."""
    base = str(tmp_path_factory.mktemp("jax_ckpt"))
    jcfg = JaxModelConfig(**TINY)
    model = jax_create_model(config=jcfg)
    variables = _random_like(init_vqa_model(model, jax.random.PRNGKey(0)), 1)
    tx, _ = make_optimizer(TrainingConfig(), 10)
    state = TrainState.create(apply_fn=model.apply, params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    tree = {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": _random_like(state.opt_state, 2), "step": jnp.asarray(12, jnp.int32)}
    jax_ckpt.save_checkpoint(base, "best_model", tree, jcfg, META)
    return base, jcfg, model


def test_a_narrow_trainer_tree_is_read_bit_equal(narrow):
    base, jcfg, _ = narrow
    want, want_cfg, want_meta = jax_ckpt.load_checkpoint(base, "best_model")
    tree, cfg, meta = ckpt_lib.load_orbax_checkpoint(base, "best_model")
    _assert_bit_equal(tree, want)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg) and meta == want_meta
    assert isinstance(tree["opt_state"], list) and tree["opt_state"][0] is None
    assert tree["opt_state"][1][0]["mu"]["answer_head"]["fc1"]["kernel"].shape == (16, 32)


def test_a_full_width_tree_is_read_bit_equal(tmp_path):
    jcfg = JaxModelConfig()
    model = jax_create_model(config=jcfg)
    shapes = jax.eval_shape(lambda: init_vqa_model(model, jax.random.PRNGKey(0)))
    variables = _random_like(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), 3)
    jax_ckpt.save_checkpoint(str(tmp_path), "best_model", dict(variables), jcfg, META)
    want, _, _ = jax_ckpt.load_checkpoint(str(tmp_path), "best_model")
    tree, _, _ = ckpt_lib.load_orbax_checkpoint(str(tmp_path), "best_model")
    _assert_bit_equal(tree, want)
    assert sum(a.size for _, a in _flat(tree)) > 19_000_000


def _write_with_tensorstore(path, name, array, chunks, fill_value, dtype_name, skip=(),
                            compressor=(("id", "zstd"), ("level", 5))):
    """A zarr v2 array written by tensorstore into the OCDBT store at
    ``path``, the chunks whose grid index is in ``skip`` never written, and
    its leaf added to ``_METADATA`` (and to ``_sharding`` where there is
    one). Returns tensorstore's own read of it."""
    store = ts.open({
        "driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}/",
                                      "path": f"{name}/"},
        "metadata": {"shape": list(array.shape), "chunks": list(chunks), "dtype": dtype_name,
                     "fill_value": fill_value,
                     "compressor": dict(compressor) if compressor else None},
        "create": True}).result()
    for idx in np.ndindex(*[-(-s // c) for s, c in zip(array.shape, chunks)]):
        if idx in skip:
            continue
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, array.shape))
        store[region].write(array[region]).result()
    meta_path = os.path.join(path, "_METADATA")
    meta = {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": False}
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
    meta["tree_metadata"][f"('{name}',)"] = {
        "key_metadata": [{"key": name, "key_type": 2}],
        "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False,
                           "write_shape": list(chunks)}}
    with open(meta_path, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    sharding_path = os.path.join(path, "_sharding")
    if os.path.exists(sharding_path):
        with open(sharding_path, encoding="utf-8") as f:
            sharding = json.load(f)
        sharding[base64.b64encode(name.encode()).decode()] = next(iter(sharding.values()))
        with open(sharding_path, "w", encoding="utf-8") as f:
            json.dump(sharding, f)
    return store.read().result()


def test_chunked_edge_and_bfloat16_arrays_are_read_bit_equal(tmp_path):
    """Orbax's own several-chunk arrays (``chunk_byte_size``) and a bf16
    one, plus arrays that tensorstore writes into the same checkpoint with
    edge chunks and zstd level 5."""
    rng = np.random.default_rng(4)
    tree = {"a": jnp.asarray(rng.standard_normal((37, 50)), jnp.float32),
            "bf": jnp.asarray(rng.standard_normal((30, 7)), jnp.bfloat16),
            "i": jnp.arange(100, dtype=jnp.int32)}
    save_args = {"a": ocp.SaveArgs(chunk_byte_size=1024), "bf": ocp.SaveArgs(chunk_byte_size=100),
                 "i": ocp.SaveArgs(chunk_byte_size=64)}
    path = str(tmp_path / "ckpt")
    with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as c:
        c.save(path, args=ocp.args.StandardSave(tree, save_args=save_args))
    _write_with_tensorstore(path, "edge", rng.standard_normal((37, 50)).astype(np.float32),
                            (16, 16), None, "<f4")
    _write_with_tensorstore(path, "edge_bf16",
                            np.asarray(rng.standard_normal((10, 9)), jnp.bfloat16),
                            (4, 4), None, "bfloat16")
    with ocp.StandardCheckpointer() as c:
        want = c.restore(path)
    _assert_bit_equal(orbax.read_checkpoint(path), want)
    zarray = json.loads(bytes(ocdbt.read_store(path)[b"a/.zarray"]))
    assert zarray["chunks"] != zarray["shape"]


def test_chunks_never_written_hold_the_fill_value(tmp_path):
    """Orbax refuses a missing chunk; tensorstore reads its fill value, and
    so does the port's reader (also a chunk stored without compression)."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / "sparse")
    want = {
        "f32": _write_with_tensorstore(path, "f32", rng.standard_normal((37, 50)).astype(
            np.float32), (16, 16), 1.5, "<f4", skip={(1, 1), (2, 3)}),
        "bf16": _write_with_tensorstore(path, "bf16", np.asarray(
            rng.standard_normal((10, 9)), jnp.bfloat16), (4, 4), -2.75, "bfloat16",
            skip={(0, 2)}),
        "i32": _write_with_tensorstore(path, "i32", np.arange(30, dtype=np.int32), (7,), 9,
                                       "<i4", skip={(4,)}),
        "raw": _write_with_tensorstore(path, "raw", rng.standard_normal((5, 3)).astype(
            np.float32), (5, 3), None, "<f4", compressor=None),
    }
    got = orbax.read_checkpoint(path)
    _assert_bit_equal(got, want)
    assert all(a.flags.writeable for a in got.values())
    assert np.all(got["f32"][16:32, 16:32] == 1.5) and np.all(got["i32"][28:] == 9)
    assert np.all(orbax.to_float32(got["bf16"])[:4, 8] == -2.75)


def test_the_plain_directory_layout_is_read_bit_equal(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": np.arange(3, dtype=np.int32)},
            "opt": [None, {"count": np.asarray(4, np.int32)}], "step": 7}
    path = str(tmp_path / "plain")
    with ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)) as c:
        c.save(path, args=ocp.args.StandardSave(tree))
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    with ocp.StandardCheckpointer() as c:
        want = c.restore(path)
    _assert_bit_equal(orbax.read_checkpoint(path), want)


def test_a_damaged_node_or_frame_raises(narrow, tmp_path):
    base, _, _ = narrow
    node_dir = tmp_path / "node"
    shutil.copytree(os.path.join(base, "best_model"), node_dir)
    node = next((node_dir / "d").iterdir())
    data = bytearray(node.read_bytes())
    data[len(data) // 2] ^= 0x10
    node.write_bytes(bytes(data))
    with pytest.raises(orbax.OrbaxError, match="CRC-32C"):
        orbax.read_checkpoint(str(node_dir))

    frame_dir = tmp_path / "frame"
    shutil.copytree(os.path.join(base, "best_model"), frame_dir)
    store = ocdbt.read_store(str(frame_dir))
    key = b"params.answer_head.fc1.kernel/0.0"
    chunk = bytes(store[key])
    for path in (frame_dir / "ocdbt.process_0" / "d").iterdir():
        blob = path.read_bytes()
        at = blob.find(chunk)
        if at >= 0:  # the chunk's frame header: a reserved bit set
            path.write_bytes(blob[:at + 4] + bytes([blob[at + 4] | 0x08]) + blob[at + 5:])
            break
    else:
        raise AssertionError("chunk not found in a data file")
    with pytest.raises(orbax.OrbaxError, match="does not decode"):
        orbax.read_checkpoint(str(frame_dir))


def test_the_read_tool_times_the_frames_the_reader_decodes(narrow, tmp_path):
    """``tools/checkpoint_read`` decodes the frames ``read_checkpoint``
    decodes, over as many copies as reach ``POOL_MB``, and reads the tree."""
    from vqa_tpu_torch.native import zstd
    from vqa_tpu_torch.tools import checkpoint_read

    base, _, _ = narrow
    frames, sizes = orbax.zstd_frames(os.path.join(base, "best_model"))
    tree = orbax.read_checkpoint(os.path.join(base, "best_model"))
    arrays = [a for _, a in _flat(tree) if isinstance(a, np.ndarray)]
    scalars = [v for _, v in _flat(tree) if isinstance(v, (int, float))]
    assert len(frames) == len(arrays) + len(scalars)  # every chunk of TINY's is compressed
    decoded = {bytes(d) for d in zstd.decompress_many(frames, sizes)}
    assert all(a.tobytes() in decoded for a in arrays)

    out = tmp_path / "read.json"
    res = checkpoint_read.main(["--checkpoint-dir", base, "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert res["chunks"] == len(frames) and res["arrays"] == len(arrays) + len(scalars)
    assert res["chunk_mb"] == sum(sizes) / 1e6 < checkpoint_read.POOL_MB
    assert res["pool"]["copies"] * res["chunk_mb"] >= checkpoint_read.POOL_MB
    assert res["one_thread"]["copies"] == 1 and res["read_ms"] > 0


def test_what_the_reader_does_not_know_raises(narrow, tmp_path):
    base, _, _ = narrow
    path = tmp_path / "zarr3"
    shutil.copytree(os.path.join(base, "best_model"), path)
    meta = json.loads((path / "_METADATA").read_text())
    meta["use_zarr3"] = True
    (path / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(orbax.OrbaxError, match="zarr3"):
        orbax.read_checkpoint(str(path))
    with pytest.raises(orbax.OrbaxError, match="not an Orbax checkpoint"):
        orbax.read_checkpoint(str(tmp_path / "nowhere"))
    with pytest.raises(orbax.OrbaxError, match="blosc"):
        orbax._ArraySpec("x", {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
                               "compressor": {"id": "blosc"}})


def test_the_seam_finds_recovers_and_prefers_the_ports_own_file(narrow, tmp_path):
    base, jcfg, _ = narrow
    shutil.copytree(os.path.join(base, "best_model"), tmp_path / "best_model.old")
    shutil.copyfile(os.path.join(base, "best_model.meta.json"),
                    tmp_path / "best_model.old.meta.json")
    # a crash inside the JAX trainer's swap left the previous tree at .old
    assert ckpt_lib.checkpoint_exists(str(tmp_path), "best_model")
    assert (tmp_path / "best_model").is_dir() and not (tmp_path / "best_model.old").exists()
    assert ckpt_lib.load_checkpoint_meta(str(tmp_path), "best_model") == META
    assert not ckpt_lib.checkpoint_exists(str(tmp_path), "latest")
    from_jax = ckpt_lib.load_model_for_inference(str(tmp_path), "best_model", device="cpu")
    # the port's own .pt, once there, comes first
    other = ckpt_lib.load_model_for_inference(base, "best_model", device="cpu")
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(2)
    ckpt_lib.save_checkpoint(str(tmp_path), "best_model",
                             {"model_state_dict": other.state_dict()}, from_jax.config, META)
    from_pt = ckpt_lib.load_model_for_inference(str(tmp_path), "best_model", device="cpu")
    for (name, a), b in zip(from_pt.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), name


def test_the_engine_and_model_follow_the_jax_engine(narrow):
    """The port's engine, loaded from the JAX directory, against the JAX
    engine loaded from it: probabilities within 1e-4, logits within 1e-3."""
    base, _, _ = narrow
    buckets = (4,)
    jax_engine = JaxInference(checkpoint_dir=base,
                              config=JaxInferenceConfig(batch_buckets=buckets),
                              dtype=jnp.float32).load()
    engine = VQAInference(checkpoint_dir=base, config=InferenceConfig(batch_buckets=buckets),
                          device="cpu").load()
    assert engine.model_loaded_from_checkpoint
    rng = np.random.default_rng(6)
    pixels = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    questions = ["what color is the cat", "how many dogs", "is this a man"]
    np.testing.assert_allclose(engine.predict_probs_from_pixels(pixels, questions),
                               jax_engine.predict_probs_from_pixels(pixels, questions),
                               rtol=0, atol=1e-4)
    ids = rng.integers(1, TINY["vocab_size"], (3, TINY["max_question_length"])).astype(np.int32)
    mask = np.ones_like(ids)
    images = (pixels.astype(np.float32) / 255.0 - 0.5) * 2
    want = np.asarray(jax_forward_logits(jax_engine.model, jax_engine.variables,
                                         jnp.asarray(images), jnp.asarray(ids),
                                         jnp.asarray(mask)))
    with torch.no_grad():
        got, _ = engine.model(torch.from_numpy(images), torch.from_numpy(ids).long(),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_the_exporter_writes_the_jax_exporters_pth(narrow, tmp_path):
    base, _, _ = narrow
    jax_export.export_checkpoint_dir(base, str(tmp_path / "jax.pth"))
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.compat.torch_export", "--checkpoint-dir", base,
         "--which", "best_model", "--out", str(tmp_path / "port.pth")],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = torch.load(tmp_path / "jax.pth", weights_only=False)
    got = torch.load(tmp_path / "port.pth", weights_only=False)
    assert got.keys() == want.keys()
    assert list(got["model_state_dict"]) == list(want["model_state_dict"])
    for key, value in want["model_state_dict"].items():
        mine = got["model_state_dict"][key]
        assert mine.dtype == value.dtype and mine.shape == value.shape, key
        assert mine.numpy().tobytes() == value.numpy().tobytes(), key
    for key in ("epoch", "best_val_accuracy", "config", "metrics_history",
                "optimizer_state_dict", "scheduler_state_dict"):
        assert got[key] == want[key], key
    # the engine reads the narrow backbone back from the weights' shapes
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="port.pth",
                          device="cpu").load()
    assert engine.model.config.stage_channels == TINY["stage_channels"]
    assert engine.model.config.feature_spatial_size == TINY["feature_spatial_size"]


def test_the_evaluator_cli_reads_a_jax_directory(narrow, capsys):
    base, _, _ = narrow
    res = evaluate.main(["--checkpoint-dir", base, "--demo", "--device", "cpu",
                         "--max-samples", "8", "--batch-size", "4"])
    assert res["num_samples"] == 8 and 0.0 <= res["top1_accuracy"] <= 1.0


def _fixture_inputs():
    spec = importlib.util.spec_from_file_location("orbax_fixture_inputs",
                                                  os.path.join(FIXTURE, "inputs.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_committed_fixture_restores_to_its_digests_and_answers():
    """orbax restores the committed directory to the SHA-256 digests in
    ``expected.npz``, and so does the port's reader; the port's f32 engine
    on the CPU gives the stored JAX probabilities within 1e-4."""
    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    digests = dict(zip(expected["names"].astype(str), expected["sha256"].astype(str)))
    want, _, _ = jax_ckpt.load_checkpoint(FIXTURE, "best_model")
    got, cfg, _ = ckpt_lib.load_orbax_checkpoint(FIXTURE, "best_model")
    for tree in (want, got):
        arrays = {".".join(p): np.asarray(v) for p, v in _flat(tree)
                  if v is not None and not isinstance(v, (int, float))}
        assert {k: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
                for k, a in arrays.items()} == digests
    assert cfg.image_size == 224
    inputs = _fixture_inputs()
    assert tuple(expected["questions"].astype(str)) == inputs.QUESTIONS
    engine = VQAInference(checkpoint_dir=FIXTURE, config=InferenceConfig(batch_buckets=(8,)),
                          device="cpu").load()
    probs = engine.predict_probs_from_pixels(inputs.images(), list(inputs.QUESTIONS))
    np.testing.assert_allclose(probs, expected["probs"], rtol=0, atol=1e-4)

