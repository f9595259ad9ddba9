"""Paged, FIT-quantized KV cache (port of ``repro.kvcache``): the host
``allocator``, the device page pools in ``paged`` and the FIT width
allocation in ``fit``. Import the submodules directly."""
