"""Data parallelism in the port's training step (``repro_torch.launch.
train``: ``entry_gradients``, ``reduce_gradients``, ``dp_train_step``, the
elastic mesh rule of ``train``) on CPU entries, at ``reduced()`` sizes in
float32. The single-entry step is held against the reference's jitted
step in ``test_torch_train.py``; here the data-parallel step is held
against it:

  * the gradient of the global batch's loss at dp 2 (and 4) equals the
    single-entry gradient within ``GRAD_TOL`` of each leaf's largest value
    (measured: under 1e-6): smollm, a masked batch (each share divided by
    the global mask's count), olmoe (the shares' router statistics
    combined before the aux loss), and olmoe with one expert over its
    capacity (the global batch's slots, in its order: without combining
    the shares the gradient is off by its own size);
  * after ``dp_train_step`` every replica holds the same bits, and the
    parameters match ``train_step``'s within ``PARAM_TOL``;
  * ``train`` over two entries follows the single-entry losses; a batch
    that does not divide falls back to dp 1; a run over a fixed mesh of
    two entries resumes bit for bit; ``main --devices``.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import train as t_train
from repro_torch.models import init_model, layers, loss_fn
from repro_torch.optim import AdamWConfig, adamw_init

GRAD_TOL = 2e-5     # of each leaf's largest gradient
PARAM_TOL = 1e-5    # of each parameter's largest value, after one step
B, S = 4, 16


@pytest.fixture(autouse=True)
def _no_batch_axes():
    yield
    layers.set_batch_axes(())


def batch_of(cfg, seed=3, mask=False, rows=B):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (rows, S))),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                      (rows, S)))}
    if mask:
        batch["mask"] = torch.from_numpy(
            (rng.random((rows, S)) > 0.35).astype(np.float32))
    return batch


def single_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return float(loss.detach()), {
        n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for n, p in model.named_parameters()}


def close(got, want, tol):
    for n, w in want.items():
        w = w.detach()
        scale = float(w.abs().max())
        assert float((got[n].detach() - w).abs().max()) <= tol * scale \
            + 1e-9, n


def overloaded(model):
    """Every MoE router biased to expert 0: it takes every token, over its
    capacity (a multiple of 128 slots) in a batch of 256 tokens."""
    with torch.no_grad():
        for b in model.blocks:
            if b.btype == "moe":
                b.moe.router[:, 0] += 1.0
    return model


CASES = {
    "smollm": ("smollm_135m", False, B, None),
    "smollm_masked": ("smollm_135m", True, B, None),
    "olmoe": ("olmoe_1b_7b", False, B, None),
    "olmoe_over_capacity": ("olmoe_1b_7b", False, 16, overloaded),
}


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_gradients_equal_the_single_entry_step(case, dp):
    arch, mask, rows, prep = CASES[case]
    cfg = configs.reduced(configs.get_config(arch))
    model = init_model(cfg, 1, device="cpu")
    if prep:
        prep(model)
    batch = batch_of(cfg, mask=mask, rows=rows)
    loss, want = single_grads(model, batch)
    replicas = [model] + [t_train.replicate(model, "cpu")
                          for _ in range(dp - 1)]
    losses, grads = t_train.entry_gradients(replicas, batch)
    assert len(grads) == dp
    assert abs(sum(float(x) for x in losses) - loss) <= 1e-5 * abs(loss)
    close(t_train.reduce_gradients(grads), want, GRAD_TOL)
    assert all(m.dispatch is None for r in replicas
               for m in t_train._moe_layers(r))


def test_combined_routing_is_what_makes_moe_exact(monkeypatch):
    """The same over-capacity case with each share routed as a batch of its
    own: the gradients are wrong (a pin that the combining is exercised)."""
    cfg = configs.reduced(configs.get_config("olmoe_1b_7b"))
    model = overloaded(init_model(cfg, 1, device="cpu"))
    batch = batch_of(cfg, rows=16)
    _, want = single_grads(model, batch)
    monkeypatch.setattr(t_train, "_route_globally", lambda *a: None)
    replicas = [model, t_train.replicate(model, "cpu")]
    _, grads = t_train.entry_gradients(replicas, batch)
    got = t_train.reduce_gradients(grads)
    worst = max(float((got[n] - w).abs().max()) / float(w.abs().max())
                for n, w in want.items() if float(w.abs().max()) > 0)
    assert worst > 0.1


def test_dp_step_keeps_replicas_equal_and_follows_train_step():
    cfg = configs.reduced(configs.get_config("smollm_135m"))
    single = init_model(cfg, 2, device="cpu")
    model = init_model(cfg, 2, device="cpu")
    replicas = [model] + [t_train.replicate(model, "cpu") for _ in range(3)]
    opt = AdamWConfig(lr=3e-3)
    s_state = adamw_init(opt, dict(single.named_parameters()))
    d_state = adamw_init(opt, dict(model.named_parameters()))
    for step in range(3):
        batch = batch_of(cfg, seed=10 + step)
        s_state, s_met = t_train.train_step(single, opt, s_state, batch, step)
        seen = []
        d_state, d_met = t_train.dp_train_step(replicas, opt, d_state, batch,
                                               step, grads_out=seen)
        assert len(seen) == 4
        assert abs(float(d_met["loss"]) - float(s_met["loss"])) <= 1e-5
        for r in replicas[1:]:
            for (n, p), q in zip(r.named_parameters(), model.parameters()):
                assert torch.equal(p, q), n
    want = dict(single.named_parameters())
    close(dict(model.named_parameters()), want, PARAM_TOL)


def _tc(tmp_path, name="ckpt", **kw):
    base = dict(steps=4, batch=B, seq_len=S, ckpt_dir=str(tmp_path / name),
                ckpt_every=2, log_every=1000, device="cpu")
    base.update(kw)
    return t_train.TrainConfig(**base)


def test_train_over_two_entries_follows_one_entry(tmp_path):
    one = t_train.train(_tc(tmp_path, "one"))
    two = t_train.train(_tc(tmp_path, "two", devices=["cpu", "cpu"]))
    assert layers.get_batch_axes() == ("data",)
    assert len(two["replicas"]) == 2 and len(one["replicas"]) == 1
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    for x, y in zip(one["doc_ids"], two["doc_ids"]):
        np.testing.assert_array_equal(x, y)


def test_a_batch_that_does_not_divide_falls_back_to_dp_1(tmp_path):
    out = t_train.train(_tc(tmp_path, steps=1, devices=["cpu"] * 3))
    assert layers.get_batch_axes() == ()
    assert len(out["replicas"]) == 1


def test_a_dp_run_resumes_bit_for_bit(tmp_path):
    two = ["cpu", "cpu"]
    a = t_train.train(_tc(tmp_path, "a", devices=two))
    t_train.train(_tc(tmp_path, "b", steps=2, devices=two))
    b = t_train.train(_tc(tmp_path, "b", devices=two))
    assert b["losses"] == a["losses"][2:]
    for r_a, r_b in zip(a["replicas"], b["replicas"]):
        for (n, p), q in zip(r_a.named_parameters(), r_b.parameters()):
            assert torch.equal(p, q), n


def test_main_takes_devices(tmp_path):
    out = t_train.main(["--device", "cpu", "--devices", "2", "--steps", "1",
                        "--batch", "2", "--seq-len", "8", "--ckpt-dir",
                        str(tmp_path / "cli")])
    assert len(out["replicas"]) == 2
    assert t_train._entries(3, "cpu") == ["cpu"] * 3
    assert t_train._entries(None, "cpu") is None
    with pytest.raises(SystemExit):
        t_train.main(["--device", "cpu", "--devices", "0"])
