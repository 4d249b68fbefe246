"""PyTorch + CUDA port of ``multimodal_clinical_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
the name and place of its JAX counterpart, and ``tests/test_torch_*.py``
hold each one against it on the CPU.  This package imports ``torch`` and
numpy only: never JAX, and nothing of the JAX package.

It covers the VGGSound jprobas run end to end:
``python -m multimodal_clinical_tpu_torch --dir vggsound`` reads the
repository's ``configs/``, serves the synthetic twin through the host feed
(``data/``: samplers, the prefetching ``Loader``), trains and validates
epoch by epoch with checkpoints and exact resume (``engine/``), and tests.
Its train step (``engine/steps.py``, ``benchmarks/vggsound_fixture.py``)
runs every TPU kernel's Hopper counterpart written for ``sm_90a`` in
``csrc/``: the log-spectrogram on the default path, the BN sums and the
stored-index max-pool behind the towers' switches, and the three tool
probes' kernels in ``tools/``.
"""
