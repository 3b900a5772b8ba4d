"""The port's training path (``repro_torch.launch.train``, the models'
gradients, ``SyntheticLMSource``, the example run) against the reference
on the CPU, at ``reduced()`` sizes in float32, B 2, S 16. The SSM and
encoder families' gradients are in ``test_torch_train_ssm.py``.

  * ``loss_fn``'s gradients equal ``jax.grad`` of the reference's for the
    seven attention architectures, on the reference's parameters carried
    across (``params_from_reference``): every leaf within ``GRAD_TOL`` of
    that leaf's largest gradient (measured: 2.7e-6 at most);
  * ``remat`` (``"full"``, ``"segments"``) gives ``"none"``'s gradients
    bit for bit and runs each attention forward twice;
  * the loss after 5 ``train_step``s equals the reference's jitted
    ``_train_step`` on the same batches (within 1e-5; measured 1e-6), and
    the parameters agree within 4e-5 of each leaf's largest value;
  * ``SyntheticLMSource.batch_at`` equals the reference's bit for bit (its
    ``extra_specs`` normals within 1e-5 relative: ``erfinv`` is torch's);
  * ``train()`` draws the same doc ids and versions as one run of the
    reference's ``train()`` (the draw pinned to flat PTBERN on both sides,
    the reference to its plain fused pipeline);
  * resume is exact, a corrupt checkpoint is skipped, a mismatched delta
    schedule raises, ``on_straggler`` fires on a slow step, and
    ``_train_step``'s hard-coded warmup ignores ``TrainConfig.warmup`` (a
    defect of the reference, kept);
  * the example run (``examples/train_lm_joinsampled.py``) holds its
    contract in one process and across restarts;
  * on the CPU no kernel launches, and the kernel route's autograd
    wrapper (over the plain forward here) gives the plain route's
    gradients.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as rc
from repro.data import PoissonJoinSource as RSource
from repro.data import SyntheticLMSource as RSynthetic
from repro.data import corpus_delta as r_corpus_delta
from repro.data import make_corpus_db as r_make_corpus_db
from repro.engine import DrawSpec as RDrawSpec
from repro.launch import train as r_train
from repro.models import init_model as r_init_model
from repro.models import loss_fn as r_loss_fn
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro_torch import configs as tc
from repro_torch import models as tm
from repro_torch.config import KernelPolicy
from repro_torch.data import PoissonJoinSource, SyntheticLMSource, corpus_delta
from repro_torch.data import make_corpus_db
from repro_torch.engine import DrawSpec
from repro_torch.examples import train_lm_joinsampled as example
from repro_torch.kernels import flash_decode, flash_prefill, fused_draw
from repro_torch.launch import train as t_train
from repro_torch.optim import AdamWConfig, adamw_init

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 2e-5     # of each leaf's largest gradient
B, S = 2, 16
ATTN_ARCHS = ("smollm_135m", "starcoder2_7b", "gemma3_1b", "llama3_405b",
              "llama32_vision_11b", "llama4_scout_17b_16e", "olmoe_1b_7b")
PREFER = KernelPolicy(prefer=True)

_SETUPS = {}


def setup_of(name: str):
    """One reference init an architecture for the file: (reference config,
    reference parameters, port config, a fresh port model from them)."""
    if name not in _SETUPS:
        rcfg = rc.reduced(rc.get_config(name))
        rparams = r_init_model(rcfg, jax.random.key(0))
        _SETUPS[name] = (rcfg, rparams, tc.reduced(tc.get_config(name)))
    rcfg, rparams, tcfg = _SETUPS[name]
    model = tm.params_from_reference(jax.tree.map(np.asarray, rparams), tcfg,
                                     "cpu")
    return rcfg, rparams, model


def batch_of(rcfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32),
             "targets": rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)}
    if rcfg.has_encoder:
        batch["frames"] = rng.standard_normal(
            (B, rcfg.n_memory_tokens, rcfg.enc_d_model)).astype(np.float32)
    elif rcfg.n_memory_tokens:
        batch["memory"] = rng.standard_normal(
            (B, rcfg.n_memory_tokens, rcfg.d_model)).astype(np.float32)
    return batch


def port_grads(model, batch) -> dict:
    """``loss_fn``'s gradient of every parameter (zeros where the loss does
    not reach, as ``jax.grad`` gives)."""
    model.zero_grad(set_to_none=True)
    loss, _ = tm.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    loss.backward()
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def check_grads(name: str) -> None:
    rcfg, rparams, model = setup_of(name)
    batch = batch_of(rcfg)
    (rloss, _), rgrads = jax.value_and_grad(r_loss_fn, has_aux=True)(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.params_to_reference(model, port_grads(model, batch))
    want = dict(leaves(jax.tree.map(np.asarray, rgrads)))
    ours = dict(leaves(got))
    assert ours.keys() == want.keys()
    for path, w in want.items():
        g = ours[path]
        assert g.shape == w.shape, path
        scale = float(np.max(np.abs(w)))
        assert float(np.max(np.abs(g - w))) <= GRAD_TOL * scale + 1e-9, path
    assert any(float(np.max(np.abs(w))) > 0 for w in want.values())


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_loss_gradients_equal_jax_grad(name):
    check_grads(name)


@pytest.mark.parametrize("remat", ["full", "segments"])
def test_remat_gives_the_same_gradients(monkeypatch, remat):
    """Four repeats of smollm's one-block pattern (segments of two): the
    gradients of ``"none"`` bit for bit, each attention forward run
    twice."""
    cfg = dataclasses.replace(tc.reduced(tc.get_config("smollm_135m")),
                              n_layers=4)
    batch = batch_of(cfg)
    want = port_grads(tm.init_model(cfg, 3, device="cpu"), batch)
    calls = []
    forward = flash_prefill.flash_prefill

    def counted(*a, **kw):
        calls.append(1)
        return forward(*a, **kw)

    monkeypatch.setattr(flash_prefill, "flash_prefill", counted)
    model = tm.init_model(dataclasses.replace(cfg, remat=remat), 3,
                          device="cpu")
    got = port_grads(model, batch)
    assert want.keys() == got.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert len(calls) == 2 * cfg.n_layers


def test_segment_factor_is_the_references():
    from repro.models.transformer import _segment_factor as r_seg
    from repro_torch.models.transformer import _segment_factor as t_seg
    for r in range(1, 41):
        for hint in (0, 2, 3, 7):
            assert t_seg(r, hint) == r_seg(r, hint), (r, hint)


@pytest.mark.parametrize("name", ["smollm_135m", "llama4_scout_17b_16e"])
def test_five_train_steps_equal_the_reference(name):
    rcfg, rparams, model = setup_of(name)
    ropt, topt = RAdamWConfig(lr=3e-3), AdamWConfig(lr=3e-3)
    rstate = r_adamw_init(ropt, rparams)
    tstate = adamw_init(topt, dict(model.named_parameters()))
    step_fn = jax.jit(functools.partial(r_train._train_step, rcfg, ropt))
    rsrc = RSynthetic(rcfg.vocab, S, B, seed=5)
    tsrc = SyntheticLMSource(rcfg.vocab, S, B, seed=5, device="cpu")
    for step in range(5):
        rparams, rstate, rmet = step_fn(rparams, rstate, rsrc.batch_at(step),
                                        jnp.asarray(step, jnp.int32))
        tstate, tmet = t_train.train_step(model, topt, tstate,
                                          tsrc.batch_at(step), step)
        assert abs(float(tmet["loss"]) - float(rmet["loss"])) <= 1e-5, step
        assert abs(float(tmet["lr"]) - float(rmet["lr"])) <= 1e-9
    assert int(tstate["step"]) == 5
    want = dict(leaves(jax.tree.map(np.asarray, rparams)))
    got = dict(leaves(tm.params_to_reference(model)))
    for path, w in want.items():
        err = float(np.max(np.abs(got[path] - w)))
        assert err <= 4e-5 * float(np.max(np.abs(w))), path


@pytest.mark.parametrize("vocab,seed", [(49_152, 0), (97, 123_456_789),
                                        (70_000, 4)])
def test_synthetic_source_equals_the_reference(vocab, seed):
    ref = RSynthetic(vocab, 33, 3, seed=seed)
    ours = SyntheticLMSource(vocab, 33, 3, seed=seed, device="cpu")
    for step in (0, 1, 17, 2**32 - 1):
        a, b = ref.batch_at(step), ours.batch_at(step)
        assert a.keys() == b.keys() == {"tokens", "targets"}
        for k in a:
            assert b[k].dtype == torch.int32
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


def test_synthetic_source_extra_specs():
    specs = {"memory": (2, 5, 8)}
    ref = RSynthetic(256, 7, 2, seed=3, extra_specs={
        "memory": jax.ShapeDtypeStruct(specs["memory"], jnp.float32)})
    ours = SyntheticLMSource(256, 7, 2, seed=3, device="cpu", extra_specs={
        "memory": torch.empty(specs["memory"], device="meta")})
    a, b = ref.batch_at(4), ours.batch_at(4)
    np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(a["tokens"]))
    assert b["memory"].dtype == torch.float32
    np.testing.assert_allclose(b["memory"].numpy(), np.asarray(a["memory"]),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticLMSource(256, 7, 2)  # the card by default


def _tc(tmp_path, name="ckpt", **kw):
    base = dict(steps=6, batch=B, seq_len=S, ckpt_dir=str(tmp_path / name),
                ckpt_every=3, log_every=1000, device="cpu")
    base.update(kw)
    return t_train.TrainConfig(**base)


def test_train_config_is_the_references():
    ours = {f.name: f.default for f in dataclasses.fields(t_train.TrainConfig)}
    want = {f.name: f.default for f in dataclasses.fields(r_train.TrainConfig)}
    assert ours.pop("device") is None
    assert ours.pop("devices") is None  # the port's mesh entries
    assert Path(ours.pop("ckpt_dir")).name == Path(want.pop("ckpt_dir")).name
    assert ours == want


def test_doc_ids_and_versions_equal_the_references_train(tmp_path,
                                                         monkeypatch):
    steps, at = 6, 3
    monkeypatch.setattr(r_train, "PoissonJoinSource", functools.partial(
        RSource, spec=RDrawSpec(method="ptbern_flat", kernels="reference")))
    monkeypatch.setattr(t_train, "PoissonJoinSource", functools.partial(
        PoissonJoinSource, spec=DrawSpec(method="ptbern_flat"),
        kernel_policy=PREFER))
    vocab = rc.reduced(rc.get_config("smollm_135m")).vocab
    rdb = r_make_corpus_db(512, 16, S + 1, vocab, seed=0)
    tdb = make_corpus_db(512, 16, S + 1, vocab, seed=0, device="cpu")
    rdelta = r_corpus_delta(rdb, S + 1, vocab, insert=64, retire=range(8),
                            seed=1)
    tdelta = corpus_delta(tdb, S + 1, vocab, insert=64, retire=range(8),
                          seed=1)
    ref = r_train.train(r_train.TrainConfig(
        steps=steps, batch=B, seq_len=S, ckpt_dir=str(tmp_path / "r"),
        log_every=1000, deltas=((at, rdelta),)))
    ours = t_train.train(_tc(tmp_path, "t", steps=steps,
                             deltas=((at, tdelta),)))
    assert ours["data_versions"] == ref["data_versions"] == [0] * at + [1] * (
        steps - at)
    assert len(ours["doc_ids"]) == steps
    for got, want in zip(ours["doc_ids"], ref["doc_ids"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(ours["losses"]) == steps and ours["final_step"] == steps


def test_resume_is_exact_and_skips_a_corrupt_checkpoint(tmp_path):
    a = t_train.train(_tc(tmp_path, "a"))
    t_train.train(_tc(tmp_path, "b", steps=3))
    b = t_train.train(_tc(tmp_path, "b"))
    assert b["losses"] == a["losses"][3:]
    for x, y in zip(a["doc_ids"][3:], b["doc_ids"]):
        np.testing.assert_array_equal(x, y)
    for n, p in b["params"].items():
        assert torch.equal(p, a["params"][n]), n
    # corrupt step 6: a restart resumes from step 3 and repeats steps 3-4
    shard = tmp_path / "b" / "step_0000000006" / "shard0.npz"
    shard.write_bytes(b"corrupted!")
    c = t_train.train(_tc(tmp_path, "b", steps=5))
    assert c["losses"] == a["losses"][3:5]


def test_a_mismatched_delta_schedule_raises(tmp_path):
    vocab = tc.reduced(tc.get_config("smollm_135m")).vocab
    db = make_corpus_db(512, 16, S + 1, vocab, seed=0, device="cpu")
    delta = corpus_delta(db, S + 1, vocab, insert=8, seed=1)
    t_train.train(_tc(tmp_path, steps=4, deltas=((2, delta),)))
    with pytest.raises(RuntimeError, match="data_version"):
        t_train.train(_tc(tmp_path, steps=6))


def test_on_straggler_fires_on_a_slow_step(tmp_path, monkeypatch):
    step_fn = t_train.train_step

    def slow_at_6(model, opt_cfg, opt_state, batch, step):
        out = step_fn(model, opt_cfg, opt_state, batch, step)
        if step == 6:
            time.sleep(2.0)
        return out

    monkeypatch.setattr(t_train, "train_step", slow_at_6)
    events, seen = [], []
    out = t_train.train(_tc(tmp_path, steps=8, ckpt_every=100,
                            data="synthetic"),
                        hooks={"on_straggler": lambda *e: events.append(e),
                               "on_step": lambda s, l: seen.append((s, l))})
    assert [e[0] for e in events] == [6]
    assert [e[0] for e in out["straggler_events"]] == [6]
    assert events[0][1] > 3.0 * events[0][2]
    assert [s for s, _ in seen] == list(range(8))
    assert [l for _, l in seen] == out["losses"]
    assert out["doc_ids"] == [] and out["data_versions"] == [0] * 8


def test_train_step_ignores_train_config_warmup(tmp_path):
    """The reference's step hard-codes ``warmup=20`` (its
    ``launch/train.py:71``), whatever ``TrainConfig.warmup`` says; the
    port keeps it."""
    a = t_train.train(_tc(tmp_path, "w3", steps=4, warmup=3,
                          data="synthetic"))
    b = t_train.train(_tc(tmp_path, "w20", steps=4, warmup=20,
                          data="synthetic"))
    assert a["losses"] == b["losses"]
    for n, p in a["params"].items():
        assert torch.equal(p, b["params"][n]), n


def test_deterministic_mode_is_restored(tmp_path):
    torch.use_deterministic_algorithms(False)
    t_train.train(_tc(tmp_path, steps=1, data="synthetic"))
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("restart", [False, True])
def test_example_run_holds_its_contract(tmp_path, restart):
    out = example.run_integration(6, 3, 2, B, S, tmp_path, device="cpu",
                                  restart=restart)
    a, b = out["a"], out["b"]
    assert a["data_versions"] == [0, 0, 1, 1, 1, 1]
    assert b["losses"] == a["losses"][3:]
    with pytest.raises(AssertionError, match="bit-identical"):
        example.check_contract(a, dict(b, losses=[x + 1e-7 for x in
                                                  b["losses"]]), 6, 3, 2)


def test_main_trains_on_the_cpu(tmp_path):
    out = t_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq-len", "16", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2
    with pytest.raises(RuntimeError, match="card"):  # the card by default
        t_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "x")])


@pytest.mark.parametrize("name", ["smollm_135m", "gemma3_1b"])
def test_kernel_route_gradients_equal_the_plain_route_on_the_cpu(
        monkeypatch, name):
    """No kernel launches here; the autograd wrapper runs over the plain
    forward, and its backward (one call a full-attention layer) gives the
    plain route's gradients within 1e-5 of each leaf's largest (measured
    7e-7: the backward recomputes the softmax in its own order)."""
    rcfg, _, model = setup_of(name)
    batch = batch_of(rcfg)
    counters = [flash_prefill.flash_prefill, flash_decode.flash_decode,
                fused_draw.fused_draw_batch]
    before = [f.launches for f in counters]
    calls = []
    backward = flash_prefill.flash_prefill_backward

    def counted(*a, **kw):
        calls.append(1)
        return backward(*a, **kw)

    monkeypatch.setattr(flash_prefill, "flash_prefill_backward", counted)
    kernel = port_grads(model, batch)
    assert len(calls) == model.cfg.repeats * sum(
        bt == "dense" for bt in model.cfg.pattern)
    model.policy = KernelPolicy(enabled=False)
    plain = port_grads(model, batch)
    assert len(calls) == model.cfg.repeats * sum(
        bt == "dense" for bt in model.cfg.pattern)
    assert [f.launches for f in counters] == before
    for n in plain:
        scale = float(plain[n].abs().max())
        assert float((kernel[n] - plain[n]).abs().max()) <= 1e-5 * scale, n
    assert any(float(g.abs().max()) > 0 for n, g in kernel.items()
               if ".attn.wq" in n)


def test_training_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.optim, repro_torch.checkpoint\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.examples.train_lm_joinsampled\n"
            "from repro_torch.data import SyntheticLMSource\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout
