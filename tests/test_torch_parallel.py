"""The port's (data, model) grid against the JAX package, on the CPU.

JAX's contract is GSPMD's: a program over a mesh computes what it computes
on one device (``tests/test_sharding.py``). The same holds here: the JAX
reference is JAX's single-device result on the same numpy inputs, and the
port runs as 4 gloo ranks (``tests/test_torch_ranks.py``; the ranks import no
JAX) over dp2×mp2 and dp1×mp4 grids, the tiny config of
``tests/test_torch_training.py`` with dropout off. In it mp2 splits every
tensor-parallel block (one head per rank) and mp4 keeps the 2-head
attention blocks whole while it splits the FFNs, the answer head and the
embedding, so one group checks both rules.

Tolerances: logits as the port's f32 forward (1e-4 abs + 1e-4 rel); one
dp2×mp2 step against JAX's at the global batch as
``tests/test_torch_training.py`` holds one step (loss 2e-5, BN statistics
1e-5, clipped gradients 1e-5 abs or 1e-4 of the tensor's max, parameters
2e-5 but where the gradient is below 1e-7); the grid's step with remat
"stages" within 1e-6 of its plain step (BN counted once); the grid's
grad_accum=2 step, unclipped, against the port's one-process step the
same way; a checkpoint written on
the grid loads strictly in one process equal to the grid's gathered state,
and the resumed step equals the continued one to the bit; the grid
evaluator's counts and predictions equal the one-process evaluator's.
Also here: the tensor-parallel rules against JAX's, the mesh's shapes and
named errors, and the serving engine's replicas.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_ranks import grid_checks, run_ranks
from vqa_tpu.compat.torch_export import _linear_kernel, _torch_key
from vqa_tpu.models import create_vqa_model as jax_create
from vqa_tpu.models import forward_logits as jax_forward_logits
from vqa_tpu.models import init_vqa_model
from vqa_tpu.parallel import mesh as jax_mesh
from vqa_tpu.training import train as jax_train
from vqa_tpu.utils.config import TrainingConfig as JaxTrainingConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.parallel import (
    Mesh,
    create_mesh,
    data_sharding,
    mesh_from_config,
    param_spec,
    variables_shardings,
)
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.training.checkpoint import load_model_for_inference
from vqa_tpu_torch.utils.config import MeshConfig, model_config_from_dict

TINY = dict(vocab_size=20, num_answers=7, embed_dim=16, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=2, dropout=0.0, answer_dropout=0.0)
# heads, FFN, cross FFN, answer head and vocabulary all divide by 4
DIVISIBLE = dict(TINY, num_attention_heads=4)
TRAIN_KW = dict(learning_rate=1e-4, warmup_epochs=0, num_epochs=3)
STEPS_PER_EPOCH = 10
GLOBAL_B = 8


def _batch(cfg, seed, n=GLOBAL_B):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    lengths = rng.integers(2, cfg.max_question_length + 1, n)
    mask = (np.arange(cfg.max_question_length)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(1, cfg.vocab_size, mask.shape) * mask).astype(np.int32)
    labels = rng.integers(0, cfg.num_answers, n).astype(np.int32)
    return images, ids, mask, labels


@functools.lru_cache(maxsize=None)
def _jax_model(**overrides):
    jmodel = jax_create(**{**TINY, **overrides})
    variables = init_vqa_model(jmodel, jax.random.PRNGKey(0))
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _port_config(jmodel):
    return model_config_from_dict(model_config_dict(jmodel.config))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(rank results, JAX logits, JAX state and metrics after one step)."""
    jmodel, variables = _jax_model()
    cfg = _port_config(jmodel)
    ref = dict(config=model_config_dict(jmodel.config),
               state=state_dict_from_jax(variables, cfg),
               batch=_batch(cfg, 1), batch2=_batch(cfg, 2), eval=_batch(cfg, 3)[:3],
               train_kw=TRAIN_KW, steps_per_epoch=STEPS_PER_EPOCH,
               tmp=str(tmp_path_factory.mktemp("grid")))
    results = run_ranks(grid_checks, 4, ref, timeout=150)
    jlogits = np.asarray(jax_forward_logits(jmodel, variables, *ref["eval"]))
    tx, _ = jax_train.make_optimizer(JaxTrainingConfig(**TRAIN_KW), STEPS_PER_EPOCH)
    jstate = jax_train.TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                         tx=tx, batch_stats=variables["batch_stats"])
    jstate, jm = jax_train.make_train_step(jmodel)(jstate, *ref["batch"],
                                                   jax.random.PRNGKey(0))
    return dict(results=results, ref=ref, cfg=cfg, jlogits=jlogits, jstate=jstate, jm=jm)


def _close_step(got_state, got_grads, want_state, want_grads, before, lr=1e-4, wd=0.01):
    """One step against another, as ``tests/test_torch_training.py`` holds
    the port's to JAX's: gradients 1e-5 abs or 1e-4 of the tensor's max;
    parameters 2e-5 but where the gradient is below 1e-7 (a first AdamW
    step is ~lr·sign(g)), where each side must be the AdamW update of its
    own gradient; BN statistics 1e-5."""
    for key, g in got_grads.items():
        wg = want_grads[key]
        tol = max(1e-5, 1e-4 * float(np.abs(wg).max()))
        np.testing.assert_allclose(g, wg, atol=tol, rtol=0, err_msg=key)
        got, exp, p0 = got_state[key], want_state[key], before[key]
        off = np.abs(got - exp) > 2e-5
        assert (np.abs(wg[off]) < 1e-7).all(), key
        for new, grad in ((got, g), (exp, wg)):
            step = p0 * (1 - lr * wd) - lr * grad / (np.abs(grad) + 1e-8)
            np.testing.assert_allclose(new, step, atol=1e-7, rtol=1e-6, err_msg=key)
    bn = [k for k in want_state if k.endswith(("running_mean", "running_var"))]
    assert len(bn) == 40
    for key in bn:
        np.testing.assert_allclose(got_state[key], want_state[key], atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name,local_heads", [("dp2xmp2", 1), ("dp1xmp4", 2)])
def test_grid_forward_matches_jax(grid, name, local_heads):
    """mp2 splits the 2-head attention (1 head per rank), mp4 keeps it whole."""
    for out in grid["results"]:
        assert out[f"heads_{name}"] == local_heads
        np.testing.assert_allclose(out[f"logits_{name}"], grid["jlogits"], atol=1e-4,
                                   rtol=1e-4)


def test_dp2_step_matches_jax_at_the_global_batch(grid):
    """One dp2×mp2 step (each data rank 4 of the 8 rows, BN over the
    global batch) against JAX's single-device step on the 8 rows."""
    step = grid["results"][0]["step"]
    jm, jstate, cfg = grid["jm"], grid["jstate"], grid["cfg"]
    loss, c1, c5 = step["metrics"]
    assert abs(loss - float(jm["loss"])) <= 2e-5
    assert (c1, c5) == (int(jm["correct1"]), int(jm["correct5"]))
    b1 = 0.9
    mu = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0].mu
    want_grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - b1), mu)}, cfg).items()}
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, cfg).items()}
    before = {k: v.numpy() for k, v in grid["ref"]["state"].items()}
    _close_step(step["state"], step["grads"], want, want_grads, before)
    # every rank holds the same gathered model
    for out in grid["results"][1:]:
        for k, v in out["step"]["state"].items():
            np.testing.assert_array_equal(v, step["state"][k], err_msg=k)


def test_remat_step_on_the_grid_equals_the_plain_grid_step(grid):
    step, remat = grid["results"][0]["step"], grid["results"][0]["remat"]
    for kind in ("state", "grads"):
        for k, v in step[kind].items():
            np.testing.assert_allclose(remat[kind][k], v, atol=1e-6, rtol=0, err_msg=k)
    assert int(remat["state"]["image_encoder.stem.1.num_batches_tracked"]) == 1


def test_grad_accum_step_on_the_grid_matches_one_process(grid):
    accum = grid["results"][0]["accum"]
    before = {k: v.numpy() for k, v in grid["ref"]["state"].items()}
    _close_step(accum["grid"], accum["grid_grads"], accum["one"], accum["one_grads"], before)
    assert int(accum["grid"]["image_encoder.stem.1.num_batches_tracked"]) == 2


def test_grid_checkpoint_loads_in_one_process_and_resumes(grid):
    out = grid["results"][0]
    model = load_model_for_inference(grid["ref"]["tmp"], "latest", device="cpu")  # strict
    state = model.state_dict()
    assert state.keys() == out["saved"].keys()
    for k, v in out["saved"].items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    assert out["resumed_step"] == (2, 2)
    for k, v in out["continued"].items():
        np.testing.assert_array_equal(out["resumed"][k], v, err_msg=k)


def test_grid_evaluator_equals_one_process(grid):
    for out in grid["results"]:
        on_grid, alone = out["evaluate"]
        assert on_grid["num_samples"] == alone["num_samples"] == 20
        for k in ("top1_accuracy", "top5_accuracy", "per_type_accuracy",
                  "per_class_accuracy_top", "error_pairs"):
            assert on_grid[k] == alone[k], k
        assert abs(on_grid["loss"] - alone["loss"]) <= 1e-6


# ---------------------------------------------------------------------------
# The tensor-parallel rules against JAX's
# ---------------------------------------------------------------------------

def _flat_params(variables):
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    return [(tuple(k.key for k in kp), leaf) for kp, leaf in flat]


@pytest.mark.parametrize("overrides", [{}, {"num_attention_heads": 4}],
                         ids=["tiny", "divisible_by_4"])
def test_tp_rules_match_jax(overrides):
    """For every parameter, JAX's rule on the flax path is the port's on the
    torch key, transposed where the flax kernel is [in, out]; on a (1, 4)
    mesh the port splits the same dimension by the same degree wherever
    its block splits, and in the config whose heads and FFNs divide by 4
    every parameter JAX splits, the port splits alike."""
    jmodel, variables = _jax_model(**overrides)
    cfg = _port_config(jmodel)
    jm = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    shardings = jax.tree_util.tree_leaves(jax_mesh.variables_shardings(variables, jm)["params"])
    port = create_vqa_model(config=cfg, device="cpu").state_dict()
    splits = variables_shardings({k: tuple(v.shape) for k, v in port.items()},
                                 Mesh(1, 4), cfg.num_attention_heads)
    split_jax = 0
    for (path, leaf), sharding in zip(_flat_params(variables), shardings):
        key, transform = _torch_key("params", path)
        spec = tuple(jax_mesh.param_spec("params/" + "/".join(path)))
        if transform is _linear_kernel:
            spec = spec[::-1]
        assert param_spec(key) == spec, key
        shard = sharding.shard_shape(leaf.shape)
        if key in splits:
            local = list(port[key].shape)
            local[splits[key]] //= 4
            assert tuple(local) == (shard[::-1] if transform is _linear_kernel else shard), key
        elif shard != leaf.shape:
            split_jax += 1
            assert "attention.W_" in key and cfg.num_attention_heads % 4, key
    # the three 2-head attention blocks (12 projections) are the only difference
    assert split_jax == (0 if overrides else 12)
    assert len(splits) == (25 if overrides else 13)


def test_param_spec_rules():
    assert param_spec("text_encoder.layers.0.self_attention.W_q.weight") == ("model", None)
    assert param_spec("text_encoder.layers.0.self_attention.W_o.weight") == (None, "model")
    assert param_spec("text_encoder.layers.0.ffn.fc1.weight") == ("model", None)
    assert param_spec("text_encoder.layers.0.ffn.fc1.bias") == ("model",)
    assert param_spec("text_encoder.layers.0.ffn.fc2.bias") == ()
    assert param_spec("fusion.cross_attention.layers.1.ffn.3.weight") == (None, "model")
    assert param_spec("answer_head.classifier.3.weight") == (None, "model")
    assert param_spec("answer_head.classifier.6.weight") == ()
    assert param_spec("image_encoder.stem.0.weight") == ()
    assert param_spec("text_encoder.token_embedding.weight") == ("model", None)
    assert jax_mesh.param_spec("params/answer_head/fc3/kernel") == P()


# ---------------------------------------------------------------------------
# Mesh shapes and named errors (tests/test_sharding.py:36-60, 307-318)
# ---------------------------------------------------------------------------

CPUS = ["cpu"] * 8


def test_create_mesh_shapes():
    assert create_mesh(devices=CPUS).shape == {"data": 8, "model": 1}
    assert create_mesh(4, 2, devices=CPUS).shape == {"data": 4, "model": 2}
    m = create_mesh()  # one process, no process group
    assert (m.shape, m.data_index, m.model_index, m.data_group) == (
        {"data": 1, "model": 1}, 0, 0, None)
    with pytest.raises(ValueError, match="needs 16 devices but only 8"):
        create_mesh(8, 2, devices=CPUS)


def test_mesh_from_config():
    """Explicit degrees honoured, auto DP clamped to the batch divisor,
    an indivisible explicit DP and a model degree that does not divide
    the devices named."""
    m = mesh_from_config(MeshConfig(data_parallel=4, model_parallel=2), devices=CPUS)
    assert m.shape == {"data": 4, "model": 2}
    assert mesh_from_config(MeshConfig(), devices=CPUS).shape == {"data": 8, "model": 1}
    m = mesh_from_config(MeshConfig(), batch_divisor=4, devices=CPUS)
    assert m.shape == {"data": 4, "model": 1}
    m = mesh_from_config(MeshConfig(model_parallel=2), batch_divisor=6, devices=CPUS)
    assert m.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="model_parallel=3 does not divide 8 devices"):
        mesh_from_config(MeshConfig(model_parallel=3), devices=CPUS)
    with pytest.raises(ValueError, match="does not divide the batch"):
        mesh_from_config(MeshConfig(data_parallel=8), batch_divisor=100, devices=CPUS)
    assert mesh_from_config(MeshConfig(data_parallel=4), batch_divisor=100,
                            devices=CPUS).shape["data"] == 4
    # over processes: one process is a 1×1 grid; more names the launcher
    assert mesh_from_config().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match=r"mesh 2×1 needs 2 processes .*--nproc-per-node 2"):
        mesh_from_config(MeshConfig(data_parallel=2))


def test_data_sharding_rows():
    m = Mesh(2, 2, data_index=1, model_index=0)
    assert data_sharding(m, 8) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        data_sharding(m, 5)


# ---------------------------------------------------------------------------
# Serving replicas
# ---------------------------------------------------------------------------

def test_two_replicas_answer_as_one():
    """Two replicas on one device (the CPU) against one: buckets round up
    to even sizes, each replica takes half, the answers are the same."""
    jmodel, _ = _jax_model()
    cfg = _port_config(jmodel)
    one = VQAInference(model_config=cfg, device="cpu").load()
    two = VQAInference(model_config=cfg, device="cpu",
                       mesh=mesh_from_config(MeshConfig(data_parallel=2), devices=["cpu"] * 2)
                       ).load()
    assert len(two.replicas) == 2 and two.replicas[1] is not two.model
    assert two._effective_buckets() == [2, 4, 16, 32] and two._bucket(1) == 2
    rng = np.random.default_rng(0)
    for n in (1, 5, 32, 40):
        pixels = rng.integers(0, 256, (n, cfg.image_size, cfg.image_size, 3), np.uint8)
        questions = ["what color is the cat"] * n
        np.testing.assert_allclose(two.predict_probs_from_pixels(pixels, questions),
                                   one.predict_probs_from_pixels(pixels, questions),
                                   atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="data-parallel grid of devices"):
        VQAInference(model_config=cfg, device="cpu", mesh=create_mesh(1, 2, devices=CPUS))
