"""The training path's gradients for the attention-free and encoder
families, against the reference on the CPU (the attention families are in
``test_torch_train.py``): ``loss_fn``'s gradients equal ``jax.grad`` of the
reference's for rwkv6-7b, zamba2-1.2b (its tied shared block) and
whisper-small (the encoder through ``frames``), every leaf within
``GRAD_TOL`` of its largest gradient; ``remat`` gives the gradients of
``"none"`` bit for bit over the encoder and the shared block.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs as tc
from repro_torch import models as tm

from test_torch_train import batch_of, check_grads, port_grads

SSM_ARCHS = ("rwkv6_7b", "zamba2_1p2b", "whisper_small")


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_loss_gradients_equal_jax_grad(name):
    check_grads(name)


@pytest.mark.parametrize("name,remat", [("whisper_small", "full"),
                                        ("zamba2_1p2b", "segments")])
def test_remat_gives_the_same_gradients(name, remat):
    cfg = tc.reduced(tc.get_config(name))
    cfg = dataclasses.replace(cfg, n_layers=4 * len(cfg.pattern))
    batch = batch_of(cfg)
    want = port_grads(tm.init_model(cfg, 5, device="cpu"), batch)
    got = port_grads(tm.init_model(dataclasses.replace(cfg, remat=remat), 5,
                                   device="cpu"), batch)
    assert want.keys() == got.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n
    assert any(float(g.abs().max()) > 0 for g in got.values())
