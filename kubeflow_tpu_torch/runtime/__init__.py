"""The runtime pieces the serving engine uses: metrics, spans, the SLO
feed (copies of their ``kubeflow_tpu.runtime`` counterparts)."""
