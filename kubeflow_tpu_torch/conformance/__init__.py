"""The port's acceptance suite (the counterpart of the repo's
``conformance/`` runner): ``python -m kubeflow_tpu_torch.conformance.run
[--live] [--device cuda|cpu]`` runs the reference's 20 checks, by the same
names and in the same order, on the port's control plane, and its
pipeline-parallel step on the card."""
