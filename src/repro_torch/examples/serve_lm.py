"""Batched serving example: prefill + lockstep greedy decode over a batch of
requests, through ``repro_torch.launch.serve.main`` in its LM mode; the
port of the reference's ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch zamba2_1p2b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

It serves the reduced config of ``--arch`` on the card by default
(``--full`` the published one); ``--device cpu`` runs the plain versions.
Every other option is ``serve``'s (``--batch``, ``--max-new``); the mode
is ``lm``, the reference's default, unless ``--mode`` says otherwise.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.launch import serve

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    """``serve.main`` with ``--mode lm`` ahead of ``argv`` (the process's
    arguments when ``None``)."""
    import sys

    return serve.main(["--mode", "lm"]
                      + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    raise SystemExit(main())
