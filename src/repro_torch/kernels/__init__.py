"""The kernel layer of the port: the paper's Table II accelerators and the
transformer's hot spots.

Counterpart of the reference's ``repro.kernels``: for the ten Table II
functions, K5 ``real_fir``, K6 ``complex_fir``, K7 ``adaptive_fir`` and K8
``iir`` (:mod:`.dsp_fir`), K9 ``vector_dot``, K10 ``vector_add``, K11
``vector_max`` and K12 ``correlation`` (:mod:`.dsp_vector`), K13
``fft``/``fft_256`` and K14 ``dct`` (:mod:`.dsp_spectral`), all in
``csrc/dsp.cu``; for the models, K15 ``flash_attention``
(:mod:`.attention`), K16 ``rmsnorm`` (:mod:`.rmsnorm`), K17 ``wkv6``
(:mod:`.rwkv6`) and K18 ``ssd`` (:mod:`.mamba2`), in
``csrc/transformer.cu``.  Each wrapper launches a hand-written CUDA kernel
for CUDA tensors and its plain torch version (:mod:`.ref`) for CPU
tensors; :mod:`.ops` holds the public ops and the accelerator dispatch
table.
"""
