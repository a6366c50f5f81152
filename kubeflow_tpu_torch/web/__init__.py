"""Web-app backends (the reference's ``crud-web-apps`` layer, SURVEY.md §2.2):
the port of ``kubeflow_tpu/web``.

Reference stack: Flask blueprints over the kubernetes python client, one
backend per app (jupyter/volumes/tensorboards) sharing the
``kubeflow.kubeflow.crud_backend`` pip package. Here the backends are
aiohttp applications sharing ``kubeflow_tpu_torch.web.common`` — async end
to end, talking to the same ``KubeApi`` surface the controllers use
(FakeKube in tests, HttpKube in deployment), so the whole stack runs in one
process when embedding and scales out as separate deployments in
production.

Modules that name no accelerator are the JAX package's, copied whole with
their imports pointed at the port. The accelerator layer sits on
``gpu/topology.py`` and the ``spec.gpu`` / ``status.gpu`` APIs: the
spawner's GPU slice picker (``jupyter.spawner_config.gpu_options``, served
at ``/api/gpus``), the form's ``spec.gpu``, the status messages with "TPU"
read as "GPU", KFAM's ``spec.gpuQuota`` and the dashboard's ``gpu-usage``
and ``gpu_duty`` series.
"""
