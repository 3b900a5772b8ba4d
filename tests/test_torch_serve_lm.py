"""The port's LM serving (``serve_batch``, ``serve --mode lm``) against the
reference's, on the CPU at ``reduced()`` sizes in float32.

  * ``serve_batch`` returns the reference's tokens exactly, request for
    request, for prompts of different lengths (padded) and different
    ``max_new``: the reference initializes from the same seed in this
    process, and its parameters are carried across
    (``params_from_reference``);
  * the reference's serving quirk is kept: after prefill, decoding starts
    by feeding the last prompt column again at position S (the pad 0 for
    a shorter prompt), and pad positions are never masked;
  * ``stats`` gets the prefill's and each step's host ms; on the CPU no
    kernel launches;
  * ``serve.main --mode lm`` answers on the CPU (reduced, and the
    published smollm-135m with ``--full``), and on the card without
    ``--full`` exits with a message naming it (decided before any card
    is touched, so it is checked here).
"""
import numpy as np
import pytest
import torch

import jax

from repro import configs as rc
from repro.launch import serve as r_serve
from repro.models import init_model as r_init_model
from repro_torch import configs as tc
from repro_torch.kernels import flash_decode, flash_prefill
from repro_torch.launch import serve
from repro_torch.models import params_from_reference

SEED = 0


def _requests(module, lens, max_new, vocab: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [module.Request(prompt=rng.integers(1, vocab, n).tolist(),
                           max_new=m) for n, m in zip(lens, max_new)]


def _port_model(arch: str):
    """The model the reference's ``serve_batch`` builds (its init from
    ``key(SEED)``, reproduced in this process), in the port."""
    rcfg = rc.reduced(rc.get_config(arch))
    tree = jax.tree.map(np.asarray, r_init_model(rcfg, jax.random.key(SEED)))
    return params_from_reference(tree, tc.reduced(tc.get_config(arch)), "cpu")


@pytest.mark.parametrize("arch", ["smollm_135m", "olmoe_1b_7b",
                                  "zamba2_1p2b", "gemma3_1b", "whisper_small",
                                  "rwkv6_7b", "starcoder2_7b",
                                  "llama32_vision_11b"])
def test_serve_batch_equals_the_reference(arch):
    lens, max_new = (5, 11, 8), (6, 4, 6)
    vocab = rc.reduced(rc.get_config(arch)).vocab
    want = r_serve.serve_batch(arch, _requests(r_serve, lens, max_new, vocab),
                               seed=SEED)
    got = serve.serve_batch(arch, _requests(serve, lens, max_new, vocab),
                            seed=SEED, params=_port_model(arch))
    for w, g, m in zip(want, got, max_new):
        assert g.prompt == w.prompt
        assert len(g.out) == m
        assert g.out == w.out


def test_serve_batch_feeds_the_last_prompt_column_again(monkeypatch):
    """The first decode step takes ``toks[:, -1:]`` (the longest prompt's
    last token, the shorter prompts' pad 0) at position S, after the
    prefill that already holds that column at S - 1."""
    seen = []
    real = serve.decode_step

    def recording(model, cache, tokens, cur):
        seen.append((tokens.clone(), int(cur)))
        return real(model, cache, tokens, cur)

    monkeypatch.setattr(serve, "decode_step", recording)
    reqs = [serve.Request(prompt=[5, 6, 7, 8], max_new=2),
            serve.Request(prompt=[9, 10], max_new=3)]
    serve.serve_batch("smollm_135m", reqs, device="cpu")
    assert [cur for _, cur in seen] == [4, 5, 6]
    assert seen[0][0].tolist() == [[8], [0]]
    assert [len(r.out) for r in reqs] == [2, 3]
    assert seen[1][0].tolist() == [[reqs[0].out[0]], [reqs[1].out[0]]]


def test_serve_batch_stats_and_no_launches_on_the_cpu():
    before = (flash_prefill.flash_prefill.launches,
              flash_decode.flash_decode.launches)
    stats = {}
    reqs = [serve.Request(prompt=[1, 2, 3], max_new=4)]
    serve.serve_batch("gemma3_1b", reqs, device="cpu", stats=stats)
    assert (flash_prefill.flash_prefill.launches,
            flash_decode.flash_decode.launches) == before
    assert stats["batch"] == 1 and stats["prompt_len"] == 3
    assert stats["cache_len"] == 3 + 4 + 1 and stats["prefill_ms"] > 0
    assert len(stats["decode_ms"]) == 4
    assert all(0 <= t < 256 for t in reqs[0].out)


def test_serve_main_lm_on_cpu(capsys):
    assert serve.main(["--mode", "lm", "--device", "cpu", "--batch", "2",
                       "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] smollm_135m (reduced) on cpu: 2 requests, 6 tokens" in out


def test_serve_main_lm_full_on_cpu(capsys):
    assert serve.main(["--mode", "lm", "--full", "--device", "cpu",
                       "--batch", "1", "--max-new", "2"]) == 0
    assert "[serve] smollm_135m on cpu: 1 requests, 2 tokens" in \
        capsys.readouterr().out


def test_serve_main_lm_on_the_card_needs_full(capsys):
    """It needs ``--full`` no longer: the reduced config's head dim 16 has
    float32 kernels. Without a card the entry point raises for the card
    (it never falls back to the CPU), and no parser error asks for
    ``--full``."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--mode", "lm"])
    assert "--full" not in capsys.readouterr().err


def test_serve_batch_refuses_sampling():
    with pytest.raises(ValueError, match="greedy"):
        serve.serve_batch("smollm_135m", [serve.Request(prompt=[1])],
                          greedy=False, device="cpu")


def test_serve_batch_draws_its_model_from_the_seed():
    """Without ``params`` the model is drawn from ``seed``: two draws of one
    seed serve the same tokens, and so does that model carrying a disabled
    ``KernelPolicy`` (the plain path, which is the CPU's anyway)."""
    from repro_torch.config import KernelPolicy
    from repro_torch.models import init_model

    def serve_one(**kw):
        return serve.serve_batch("smollm_135m", [serve.Request([4, 5, 6], 5)],
                                 **kw)[0].out

    a = serve_one(seed=11, device="cpu")
    b = serve_one(seed=11, device=torch.device("cpu"))
    off = init_model(tc.reduced(tc.get_config("smollm_135m")), 11,
                     device="cpu", policy=KernelPolicy(enabled=False))
    assert a == b == serve_one(params=off)
