"""The serving data plane on PyTorch.

- :mod:`kubeflow_tpu_torch.serving.engine` — the serving loop: paged KV
  admission, prefill/decode lanes, warm model standbys, park / warm
  restore, over the burn-in transformer.
- :mod:`kubeflow_tpu_torch.serving.kvcache` — the KV block pool.
- :mod:`kubeflow_tpu_torch.serving.loadgen` — seeded open-loop traces.
"""
