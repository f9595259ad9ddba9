"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The module layout mirrors ``src/repro/`` one to one, so each counterpart
is found by name. Parameters stay nested dicts keyed like the
reference's tree (``layers/0/attn/wq``), in its ``(K, N)`` layout
(``y = x @ w``).

The hot kernels (``kernels.ef_sqnorm``, ``kernels.qmm``,
``kernels.paged_attention``) are hand-written CUDA C++ for ``sm_90a``,
built with ``nvcc`` at first use. On a CPU tensor every kernel wrapper
takes its plain PyTorch version instead; on a CUDA tensor it launches
the kernel or raises.

Entry points (``init_params``, ``build_report``, ``quantize_params``,
``Engine``) run on ``"cuda"`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back.
"""
