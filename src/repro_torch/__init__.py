"""PyTorch/CUDA port of the trust-IR load shedder (``repro``'s twin).

Module paths mirror ``repro``: ``repro_torch.core.shedder`` is the
counterpart of ``repro.core.shedder`` and is tested against it. The port
imports ``torch`` and numpy only, never ``jax`` and nothing of ``repro``.

Entry points (``make_evaluator``, ``LoadShedder``,
``FusedLoadShedder``, the kernel wrappers) run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise instead of
falling back to the CPU (``repro_torch.device.resolve``).
"""
