"""The trainer's and the evaluator's CUDA graphs (``training/step_graph.py``,
``utils/graphs.py``), on the CPU.

CUDA graphs exist only on the card, so here a stand-in takes the place of
each capture: it runs the captured function once to learn its outputs
and then puts back every state that run moved (the model's parameters
and buffers, the optimizer's state, the dropout and augmentation
generators), because a capture executes nothing; its replay runs the
function again from the static inputs into the static outputs, which is
what a graph's replay computes. Through it the trainer's graphed path
runs as it does on the card: the first steps of each shape are real
eager steps, then capture and replays; the learning rate is written in
place before each replay; each replay returns copies of its outputs; a
capture comes after ``resume``, and a resume after a capture loads into
the tensors the graph captured; a failed capture raises. The real
``capture`` runs with ``torch.cuda``'s graph calls replaced, for its
launch accounting. The eager rule and the in-place bf16 weight copies
need no stand-in.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from vqa_tpu_torch import ops
from vqa_tpu_torch.data.dataset import create_demo_loaders
from vqa_tpu_torch.data.synthetic import create_synthetic_loaders
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.ops._build import count_launch
from vqa_tpu_torch.training import evaluate as eval_mod
from vqa_tpu_torch.training import step_graph
from vqa_tpu_torch.training import train as train_mod
from vqa_tpu_torch.utils import graphs
from vqa_tpu_torch.utils.config import ModelConfig, TrainingConfig
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = ModelConfig(vocab_size=50, num_answers=8, embed_dim=16, num_transformer_layers=1,
                   num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
                   image_size=32, base_channels=8, stage_channels=(8, 16, 32, 64),
                   feature_spatial_size=1)
PER_FORWARD = {"stem": 1, "se": 4, "cross_attention": 2}


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    # oneDNN's CPU convolution backward crashes in a process that has run
    # XLA:CPU programs (another test file may have, in the same worker)
    with torch.backends.mkldnn.flags(enabled=False):
        yield


class StandInGraph:
    """A captured graph's replay: the function again, from the static
    inputs into the static outputs. A train step's graph (``params``: the
    parameters it steps) also writes each gradient into the tensor its
    first replay left in ``.grad``, as a graph writes the memory its
    capture allocated."""

    def __init__(self, fn, inputs, output, on_replay=None, params=None):
        self.fn, self.inputs, self.output, self.on_replay = fn, inputs, output, on_replay
        self.params, self.grads = params, None
        self.replays = 0

    def replay(self):
        if self.on_replay is not None:
            self.on_replay()
        out = self.fn(*self.inputs)
        with torch.inference_mode():  # the static outputs of an eval step are inference tensors
            _copy_into(self.output, out)
        if self.params is not None:
            if self.grads is None:
                self.grads = [p.grad for p in self.params]
            for p, g in zip(self.params, self.grads):
                if g is not None and p.grad is not g:
                    g.copy_(p.grad)
                    p.grad = g
        self.replays += 1


def _copy_into(static, out):
    if isinstance(static, torch.Tensor):
        static.copy_(out)
    elif isinstance(static, dict):
        for k in static:
            _copy_into(static[k], out[k])


class StandIns:
    """``graphs.capture`` replaced: the capture runs ``fn`` once for its
    outputs and restores what that moved (``trainers``' models and
    optimizers, the CPU generator and the registered generators)."""

    def __init__(self, monkeypatch, *trainers, fail=None, on_replay=None):
        self.trainers, self.fail, self.on_replay = trainers, fail, on_replay
        self.captured, self.events = [], []
        monkeypatch.setattr(graphs, "capture", self.capture)

    def capture(self, fn, inputs, pool, generators=()):
        self.events.append("capture")
        if self.fail:
            raise RuntimeError(self.fail)
        saved = [self._snapshot(t) for t in self.trainers]
        rng = torch.get_rng_state()
        gens = [g.get_state() for g in generators]
        output = fn(*inputs)
        for t, s in zip(self.trainers, saved):
            self._restore(t, s)
        torch.set_rng_state(rng)
        for g, s in zip(generators, gens):
            g.set_state(s)
        # a train step's body returns its loss and counts
        params = ([p for t in self.trainers for p in t.model.parameters()]
                  if isinstance(output, dict) and "correct1" in output and "loss" in output
                  else None)
        graph = graphs.BucketGraph(StandInGraph(fn, inputs, output, self.on_replay, params),
                                   inputs, output, {})
        self.captured.append(graph)
        return graph

    @staticmethod
    def _snapshot(trainer):
        tensors = list(trainer.model.parameters()) + list(trainer.model.buffers())
        opt = trainer.state.optimizer
        return ([t.detach().clone() for t in tensors],
                {p: {k: v.clone() for k, v in st.items()} for p, st in opt.state.items()})

    @staticmethod
    def _restore(trainer, saved):
        values, opt_state = saved
        tensors = list(trainer.model.parameters()) + list(trainer.model.buffers())
        with torch.no_grad():
            for t, v in zip(tensors, values):
                t.copy_(v)
        state = trainer.state.optimizer.state
        for p in list(state):
            if p not in opt_state:
                del state[p]
        for p, st in opt_state.items():
            for k, v in st.items():
                state[p][k].copy_(v)


def _graphed(monkeypatch):
    """Make the eager rule let the CPU trainer and evaluator graph."""
    monkeypatch.setattr(step_graph, "eager_reason", lambda model, debug_nans=False: None)


def _trainer(train_loader, val_loader, seed=3, dropout=0.1, model_cfg=TINY, **cfg):
    model = create_vqa_model(config=dataclasses.replace(model_cfg, dropout=dropout,
                                                        answer_dropout=dropout),
                             device="cpu", seed=seed)
    return train_mod.Trainer(model, train_loader, val_loader,
                             config=TrainingConfig(warmup_epochs=1, num_epochs=2, **cfg),
                             save_checkpoints=False, seed=seed)


def _demo(batch=2, samples=16, eval_batch=4):
    return create_demo_loaders(
        batch_size=batch, eval_batch_size=eval_batch, num_samples=samples,
        image_size=TINY.image_size, max_question_length=TINY.max_question_length,
        vocab_size=TINY.vocab_size, num_answers=TINY.num_answers, seed=5)


def _batches(n, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(a) for a in (
        rng.standard_normal((b, TINY.image_size, TINY.image_size, 3)).astype(np.float32),
        rng.integers(4, TINY.vocab_size, (b, TINY.max_question_length)).astype(np.int32),
        np.ones((b, TINY.max_question_length), np.int32),
        rng.integers(0, TINY.num_answers, b).astype(np.int32))] for _ in range(n)]


def _state_of(trainer):
    opt = trainer.state.optimizer
    return ([t.detach().clone() for t in trainer.model.state_dict().values()],
            [{k: v.clone() for k, v in opt.state[p].items()} for p in trainer.model.parameters()],
            trainer.state.step)


def _assert_same_state(a, b):
    (ta, oa, sa), (tb, ob, sb) = a, b
    assert sa == sb
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
               for x, y in zip(oa, ob))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_warm_steps_are_real_and_the_graphed_run_follows_the_eager_states(
        monkeypatch, grad_accum):
    """Four steps with dropout on: two eager warm steps, a capture and
    its replay, one more replay. After every step the parameters, BN's
    statistics, AdamW's state and the step count equal the eager run's."""
    batches = _batches(4)
    loaders = _demo()
    eager = _trainer(*loaders, grad_accum=grad_accum)
    want, losses = [], []
    for b in batches:
        losses.append(float(eager.train_step(eager.state, *b)["loss"]))
        want.append(_state_of(eager))
    _graphed(monkeypatch)
    trainer = _trainer(*loaders, grad_accum=grad_accum)
    assert isinstance(trainer.train_step, step_graph.GraphedTrainStep)
    stand_ins = StandIns(monkeypatch, trainer)
    for i, b in enumerate(batches):
        m = trainer.train_step(trainer.state, *b)
        assert float(m["loss"]) == losses[i]
        _assert_same_state(_state_of(trainer), want[i])
    calls = trainer.train_step.calls
    assert (calls.eager_calls, calls.replays) == (graphs.WARM_FORWARDS, 2)
    assert len(stand_ins.captured) == 1 and stand_ins.captured[0].graph.replays == 2
    assert len(set(losses)) == 4


def test_the_learning_rate_tensor_holds_the_schedule_at_every_replay(monkeypatch):
    """The card's AdamW reads its rate from a tensor: each replay sees
    ``schedule(step)`` there, in the one tensor the capture saw."""
    _graphed(monkeypatch)
    trainer = _trainer(*_demo())
    lr = torch.tensor(0.0)
    for g in trainer.state.optimizer.param_groups:
        g["lr"] = lr
    ptr, seen = lr.data_ptr(), []
    StandIns(monkeypatch, trainer,
             on_replay=lambda: seen.append((lr.data_ptr(), float(lr), trainer.state.step)))
    for b in _batches(6):
        trainer.train_step(trainer.state, *b)
    assert len(seen) == 6 - graphs.WARM_FORWARDS
    for p, value, step in seen:
        assert p == ptr and value == pytest.approx(trainer.schedule(step), rel=1e-6)
    assert trainer.state.optimizer.param_groups[0]["lr"] is lr


def test_epoch_metrics_are_the_steps_not_the_last_replay(monkeypatch):
    """Each replay returns copies, so the epoch's loss is the mean of its
    steps' losses, as eagerly (eight steps, six of them replays)."""
    loaders = _demo()
    loaders[0].set_epoch(0)  # the same shuffle for both runs
    want = _trainer(*loaders).train_epoch(0)
    _graphed(monkeypatch)
    trainer = _trainer(*loaders)
    StandIns(monkeypatch, trainer)
    loaders[0].set_epoch(0)
    got = trainer.train_epoch(0)
    assert trainer.train_step.calls.replays == len(loaders[0]) - graphs.WARM_FORWARDS >= 4
    assert got == want


def test_device_augmentation_replays_its_seeded_draws(monkeypatch):
    """uint8 batches augmented by the trainer's graph: the same pixels as
    the eager augmentation from the same (epoch, step) seeds, and the
    epoch's metrics as eagerly."""
    train_loader, val_loader, tok, vocab = create_synthetic_loaders(
        num_samples=30, batch_size=4, eval_batch_size=4, image_size=TINY.image_size,
        max_question_length=TINY.max_question_length, device_augment=True, seed=2)
    cfg = dataclasses.replace(TINY, vocab_size=tok.vocab_size, num_answers=vocab.num_answers)
    eager = _trainer(train_loader, val_loader, model_cfg=cfg)
    _graphed(monkeypatch)
    trainer = _trainer(train_loader, val_loader, model_cfg=cfg)
    StandIns(monkeypatch, trainer)
    pixels = torch.from_numpy(next(iter(train_loader))["image"])
    assert pixels.dtype == torch.uint8
    for step in range(5):
        assert torch.equal(trainer.augment(pixels, 0, step), eager.augment(pixels, 0, step))
    assert trainer._augment.replays == 5 - graphs.WARM_FORWARDS
    got = {}
    for name, t in (("eager", eager), ("graphed", trainer)):
        train_loader.set_epoch(1)
        torch.manual_seed(11)  # the same dropout masks for both
        got[name] = t.train_epoch(1)
    assert got["graphed"] == got["eager"]


def test_validation_and_the_evaluator_replay_without_aliasing(monkeypatch):
    """The graphed validation and evaluation (six batches, four replays)
    give the eager results; each replay's outputs are copies."""
    loaders = _demo(samples=120, eval_batch=4)
    eager = _trainer(*loaders)
    want_val = eager.validate()
    want_eval = eval_mod.Evaluator(eager.model).evaluate(loaders[1])
    _graphed(monkeypatch)
    trainer = _trainer(*loaders)
    stand_ins = StandIns(monkeypatch, trainer)
    assert trainer.validate() == want_val
    assert trainer.val_step.replays == len(loaders[1]) - graphs.WARM_FORWARDS >= 4
    ev = eval_mod.Evaluator(trainer.model)
    got = ev.evaluate(loaders[1])
    assert ev._eval_step.replays >= 4
    assert got == want_eval
    assert len(stand_ins.captured) == 2  # one validation, one evaluation graph


def test_the_graphs_read_the_weights_of_each_epoch(monkeypatch):
    """A validation graph captured in epoch 0 gives epoch 1's eager
    validation on epoch 1's weights, in bf16 (the copies it reads are
    refreshed in place): eight steps an epoch, and epoch 1's two
    validation batches are both replays."""
    loaders = _demo(batch=4, samples=40, eval_batch=4)
    _graphed(monkeypatch)
    trainer = _trainer(*loaders)
    trainer.model.set_compute_dtype(torch.bfloat16)
    StandIns(monkeypatch, trainer)
    trainer.train_epoch(0)
    first = trainer.validate()
    trainer.train_epoch(1)
    second = trainer.validate()
    assert trainer.val_step.replays == 2 * len(loaders[1]) - graphs.WARM_FORWARDS
    eager = train_mod.make_val_step(trainer.model)
    want = {}
    for batch in loaders[1]:
        out = eager(*(torch.from_numpy(batch[k]) for k in (
            "image", "token_ids", "attention_mask", "answer", "valid_mask")))
        want = {k: want.get(k, 0.0) + float(v) for k, v in out.items()}
    assert second["val_loss"] == pytest.approx(want["loss_sum"] / want["n"], rel=1e-6)
    assert second["val_top1"] == want["correct1"] / want["n"]
    assert second["val_loss"] != first["val_loss"]


def test_capture_comes_after_resume(monkeypatch, tmp_path):
    """``Trainer.train`` captures at its first steps, after ``resume``
    replaced the optimizer's state; the resumed graphed run ends where the
    uninterrupted one does."""
    _graphed(monkeypatch)
    # dropout off: a Trainer seeds its dropout generator when it is built
    whole = _trainer(*_demo(), dropout=0.0)
    StandIns(monkeypatch, whole)
    whole.train()
    first = _trainer(*_demo(), dropout=0.0)
    first.cfg.num_epochs = 1
    first.checkpoint_dir, first.save_checkpoints = str(tmp_path), True
    StandIns(monkeypatch, first)
    first.train()
    resumed = _trainer(*_demo(), dropout=0.0)
    resumed.checkpoint_dir = str(tmp_path)
    stand_ins = StandIns(monkeypatch, resumed)
    real_resume = resumed.resume
    monkeypatch.setattr(resumed, "resume",
                        lambda name: (stand_ins.events.append("resume"), real_resume(name)))
    resumed.resume("latest")
    resumed.train()
    assert stand_ins.events[0] == "resume" and "capture" in stand_ins.events
    for a, b in zip(whole.model.state_dict().values(), resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_a_resume_after_the_capture_loads_into_the_captured_state(monkeypatch, tmp_path):
    """A graph reads and writes the optimizer state tensors it captured,
    so the stand-in's replays step those tensors, whatever the optimizer
    holds then. A resume after the capture puts the checkpoint's moments
    and counts into them: the run then follows the eager run that took
    the same steps."""
    batches = _batches(6)
    eager = _trainer(*_demo(), dropout=0.0)
    for b in batches:
        eager.train_step(eager.state, *b)
    _graphed(monkeypatch)
    trainer = _trainer(*_demo(), dropout=0.0)
    trainer.checkpoint_dir, trainer.save_checkpoints = str(tmp_path), True
    opt, params = trainer.state.optimizer, list(trainer.model.parameters())
    captured = []

    def replay_on_the_captured_tensors():
        if not captured:
            captured.extend(dict(opt.state[p]) for p in params)
        for p, st in zip(params, captured):
            opt.state[p].update(st)

    StandIns(monkeypatch, trainer, on_replay=replay_on_the_captured_tensors)
    for b in batches[:3]:  # two eager warm steps, the capture and its replay
        trainer.train_step(trainer.state, *b)
    trainer.save("latest", epoch=0)
    for b in batches[3:5]:  # two replays the resume takes back
        trainer.train_step(trainer.state, *b)
    trainer.resume("latest")
    for b in batches[3:]:
        trainer.train_step(trainer.state, *b)
    assert trainer.train_step.calls.replays == 6 and len(captured) == len(params)
    assert all(opt.state[p][k] is t for p, st in zip(params, captured) for k, t in st.items())
    _assert_same_state(_state_of(trainer), _state_of(eager))


def test_a_failed_capture_raises_and_nothing_runs_eagerly_in_its_place(monkeypatch):
    _graphed(monkeypatch)
    trainer = _trainer(*_demo())
    StandIns(monkeypatch, trainer, fail="operation not permitted when stream is capturing")
    batches = _batches(4)
    for b in batches[:graphs.WARM_FORWARDS]:
        trainer.train_step(trainer.state, *b)
    step = trainer.state.step
    for b in batches[graphs.WARM_FORWARDS:]:
        with pytest.raises(RuntimeError, match="stream is capturing"):
            trainer.train_step(trainer.state, *b)
    assert trainer.train_step.calls.eager_calls == graphs.WARM_FORWARDS
    assert trainer.state.step == step  # no step was taken in its place


class _Model:
    def __init__(self, device, backend=None):
        self.device = torch.device(device)
        self.mesh = None if backend is None else types.SimpleNamespace(world_group=backend)

    def parameters(self):
        yield types.SimpleNamespace(device=self.device)


@pytest.mark.parametrize("device,backend,debug_nans,eager", [
    ("cpu", None, False, "on the CPU"), ("cuda", None, True, "--debug-nans"),
    ("cuda", "gloo", False, "gloo"), ("cuda", "nccl", True, "--debug-nans"),
    ("cuda", None, False, None), ("cuda", "nccl", False, None)])
def test_the_eager_rule(monkeypatch, device, backend, debug_nans, eager):
    monkeypatch.setattr(step_graph.dist, "get_backend", lambda group: group)
    reason = step_graph.eager_reason(_Model(device, backend), debug_nans)
    assert (reason is None) if eager is None else (eager in reason)
    assert step_graph.describe(reason) == (
        "one CUDA graph per batch shape" if eager is None else f"eager ({reason})")


def test_the_trainer_logs_and_keeps_the_rule(capsys):
    trainer = _trainer(*_demo())
    assert trainer.train_step is trainer.eager_train_step
    assert isinstance(trainer.val_step, types.FunctionType)
    assert ("train steps and device augmentation: eager (a model on the CPU"
            in capsys.readouterr().out)


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def replay(self):
        pass


def _counted(x):
    """An eval forward's launches, as the wrappers count them on the card."""
    count_launch(ops.fused_stem)
    for _ in range(4):
        count_launch(ops.fused_se)
    for _ in range(2):
        count_launch(ops.fused_cross_attention)
    return {"out": x * 2}


def test_launches_are_counted_per_replay(monkeypatch):
    """The real ``capture`` with ``torch.cuda``'s graph calls replaced: the
    warm calls count, the capture counts nothing, each replay adds what
    one forward launches."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    calls = graphs.GraphedCalls(_counted)
    before = ops.launch_counts()
    for i in range(6):
        out = calls(torch.full((3,), float(i)))
        assert torch.equal(out["out"], torch.full((3,), 2.0 * i)) or i > graphs.WARM_FORWARDS
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **dict.fromkeys(ops.KERNELS, 0), **{k: 6 * v for k, v in PER_FORWARD.items()}}
    assert (calls.eager_calls, calls.replays) == (graphs.WARM_FORWARDS, 4)
    assert next(iter(calls.graphs.values())).launches == PER_FORWARD


def test_bf16_copies_are_refreshed_in_place():
    """train → eval → a weight change → train → eval: each bf16 copy keeps
    its memory (a captured eval graph reads it) and equals its weight
    rounded to bf16; training mode casts the f32 weight instead."""
    model = create_vqa_model(config=TINY, device="cpu", seed=1, dtype=torch.bfloat16)
    copies = {n: b for n, b in model.named_buffers() if n.split(".")[-1].startswith("compute_")}
    ptrs = {n: b.data_ptr() for n, b in copies.items()}
    assert copies
    model.train()
    model.eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.125)
    model.train()
    fc1 = model.text_encoder.layers[0].ffn.fc1
    assert fc1.compute("weight").requires_grad and fc1.compute("weight") is not fc1.compute_weight
    model.eval()
    buffers = dict(model.named_buffers())
    for name, ptr in ptrs.items():
        copy_ = buffers[name]
        module = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        source = getattr(module, name.rsplit(".", 1)[-1][len("compute_"):])
        assert copy_.data_ptr() == ptr, name
        assert torch.equal(copy_, source.detach().to(torch.bfloat16)), name


def test_checkpoints_keep_the_plain_optimizer_form(tmp_path):
    """A capturable AdamW's state (a rate tensor, step counts as tensors,
    ``capturable`` on) is written in the plain form, and either form
    loads into the plain optimizer with its own rate kept."""
    trainer = _trainer(*_demo(), dropout=0.0)
    for b in _batches(2):
        trainer.train_step(trainer.state, *b)
    plain = trainer.state.optimizer.state_dict()
    as_card = copy.deepcopy(plain)
    for g in as_card["param_groups"]:
        g.update(lr=torch.tensor(g["lr"]), capturable=True)
    for st in as_card["state"].values():
        st["step"] = st["step"].clone().reshape(())
    portable = train_mod.portable_optimizer_state(as_card)
    assert all(g["capturable"] is False and isinstance(g["lr"], float)
               for g in portable["param_groups"])
    for got, want in zip(portable["param_groups"], plain["param_groups"]):
        assert got == {**want, "lr": got["lr"]}
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)  # a f32 tensor's rate
    own_lr = trainer.state.optimizer.param_groups[0]["lr"]
    train_mod.load_optimizer_state(trainer.state.optimizer, as_card)
    group = trainer.state.optimizer.param_groups[0]
    assert group["capturable"] is False and group["lr"] == own_lr
    after = trainer.state.optimizer.state_dict()
    for i, st in plain["state"].items():
        assert all(torch.equal(st[k], after["state"][i][k]) for k in st)
