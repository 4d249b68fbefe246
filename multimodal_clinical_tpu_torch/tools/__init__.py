"""The measurement probes of ``tools/`` that run a TPU kernel, ported with
their kernels: the same module names, so a reader finds the counterpart.

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
"""
