"""PyTorch + CUDA port of ``multimodal_clinical_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
the name and place of its JAX counterpart, and ``tests/test_torch_port_*.py``
hold each one against it on the CPU.  This package imports ``torch`` and
numpy only — never JAX, and nothing of the JAX package.

Slice 1 covers the VGGSound jprobas train and eval step
(``benchmarks/vggsound_fixture.py``), with the log-spectrogram as a CUDA
kernel written for ``sm_90a`` (``csrc/log_spectrogram.cu``).
"""
