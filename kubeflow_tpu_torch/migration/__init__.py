"""The drain/checkpoint/restore protocol's pure core, as the SDK needs it
(a trimmed copy of ``kubeflow_tpu.migration``)."""
