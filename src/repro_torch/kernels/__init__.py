"""The DSP kernel layer of the port (the paper's Table II accelerators).

Counterpart of the reference's ``repro.kernels`` for the four functions of
the audio pipeline: K5 ``real_fir`` (:mod:`.dsp_fir`), K9 ``vector_dot``
and K12 ``correlation`` (:mod:`.dsp_vector`), K13 ``fft``/``fft_256``
(:mod:`.dsp_spectral`).  Each wrapper launches a hand-written CUDA kernel
(``csrc/dsp.cu``) for CUDA tensors and its plain torch version
(:mod:`.ref`) for CPU tensors; :mod:`.ops` holds the public ops and the
accelerator dispatch table.
"""
