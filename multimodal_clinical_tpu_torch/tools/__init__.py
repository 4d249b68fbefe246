"""The JAX package's ``tools/`` that the port carries, under the same
module names, so a reader finds the counterpart.

The measurement probes that run a TPU kernel, ported with their kernels:

- ``proto_pallas_conv``: the 3x3 SAME conv kernel (``csrc/conv3x3.cu``)
  against cuDNN at the ResNet stage geometries;
- ``proto_bn_stats``: conv -> one-pass BN statistics
  (``csrc/bn_stats.cu``) -> scale, shift, ReLU -> sum;
- ``probe_pallas_layout``: conv -> ReLU -> identity copy
  (``csrc/identity_copy.cu``) of the map or of its (H, W, C, N) view ->
  max-pool -> sum.

Each ``main`` runs on the card (``python -m
multimodal_clinical_tpu_torch.tools.<name>``) and raises without CUDA;
``build`` takes ``device="cpu"`` for the tests.

The serving and analysis tools: ``predict`` (batch inference from a
checkpoint), ``export`` (a ``torch.export`` serving artifact and
``load_artifact``), ``analyze_runs`` (the reference's W&B CSV layout),
``noise_sweep`` (Enrico's noise sweep over the multi-seed sweep),
``parity_run`` (the accuracy-parity harness) and ``preprocess`` (the
offline preprocessing stage).  Each that uses the device runs on CUDA
unless given ``--device cpu``.
"""
