"""PodDefault → Pod injection engine.

Behavior-compatible with the reference webhook (``admission-webhook/main.go``):

- ``filter_poddefaults`` — label-selector match (:72-97)
- ``safe_to_apply``      — pure merge dry-run, conflict-as-error (:101-150)
- ``apply_poddefaults``  — the actual mutation (:480-597), stamping
  ``poddefault.admission.kubeflow.org/poddefault-<name>: <resourceVersion>``
- exclusion annotation ``poddefault.admission.kubeflow.org/exclude: "true"``
  and mirror-pod skip (:625-633)

Merge semantics (one generic keyed merge replaces the reference's six
hand-rolled Go functions, :168-475):

- keyed lists (env by name, volumes by name, volumeMounts by name AND by
  mountPath, containers by name, tolerations by key, imagePullSecrets by
  name): absent → append; present-and-identical → no-op; present-but-
  different → **conflict error**
- envFrom: plain append
- labels/annotations maps: absent → set; different value → conflict
- command/args: set only when the container has none (never overwritten)
- serviceAccountName/automountServiceAccountToken: last PodDefault wins

The port's copy of ``kubeflow_tpu/webhooks/poddefault.py``: it keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import (
    deep_get,
    deepcopy,
    get_meta,
    matches_selector,
    name_of,
)

ANNOTATION_PREFIX = "poddefault.admission.kubeflow.org"
EXCLUDE_ANNOTATION = f"{ANNOTATION_PREFIX}/exclude"
MIRROR_POD_ANNOTATION = "kubernetes.io/config.mirror"
ISTIO_PROXY_CONTAINER = "istio-proxy"


class MergeConflict(Invalid):
    """A PodDefault collides with the pod (or another PodDefault)."""


def _merge_keyed(
    existing: list[dict],
    incoming: list[tuple[str, dict]],  # (poddefault-name, item)
    key_fns,
    what: str,
) -> list[dict]:
    """Generic conflict-checked merge. ``key_fns`` is one or more functions
    extracting an identity key; an item conflicts if ANY key matches an
    existing item that isn't deep-equal (the volumeMounts name+mountPath
    double check, main.go:266-311)."""
    if callable(key_fns):
        key_fns = (key_fns,)
    merged = [deepcopy(item) for item in existing]
    indexes: list[dict] = [
        {fn(item): item for item in merged if fn(item) is not None}
        for fn in key_fns
    ]
    errs: list[str] = []
    for pd_name, item in incoming:
        clash = None
        fresh = True
        for fn, index in zip(key_fns, indexes):
            key = fn(item)
            if key is None:
                continue
            found = index.get(key)
            if found is None:
                index[key] = item
            else:
                fresh = False
                if found != item:
                    clash = (fn(item), found)
        if clash is not None:
            errs.append(
                f"merging {what} for PodDefault {pd_name} conflicts on "
                f"{clash[0]!r}: {item} does not match existing {clash[1]}"
            )
        elif fresh:
            merged.append(deepcopy(item))
    if errs:
        raise MergeConflict("; ".join(errs))
    return merged


def _merge_map(existing: dict, incoming: list[tuple[str, dict]], what: str) -> dict:
    out = dict(existing or {})
    errs = []
    for pd_name, mapping in incoming:
        for k, v in (mapping or {}).items():
            if k in out and out[k] != v:
                errs.append(
                    f"merging {what} for PodDefault {pd_name} conflicts on "
                    f"{k!r}: {v!r} != {out[k]!r}"
                )
            else:
                out[k] = v
    if errs:
        raise MergeConflict("; ".join(errs))
    return out


def _collect(pds: list[dict], field: str) -> list[tuple[str, dict]]:
    out = []
    for pd in pds:
        for item in deep_get(pd, "spec", field, default=[]) or []:
            out.append((name_of(pd), item))
    return out


def _collect_maps(pds: list[dict], field: str) -> list[tuple[str, dict]]:
    return [
        (name_of(pd), deep_get(pd, "spec", field, default={}) or {}) for pd in pds
    ]


def filter_poddefaults(pds: list[dict], pod: dict) -> list[dict]:
    """PodDefaults whose spec.selector matches the pod's labels (main.go:72-97)."""
    labels = get_meta(pod).get("labels") or {}
    return [
        pd
        for pd in sorted(pds, key=name_of)
        if matches_selector(labels, deep_get(pd, "spec", "selector", default={}))
    ]


def is_excluded(pod: dict) -> bool:
    annotations = get_meta(pod).get("annotations") or {}
    return (
        annotations.get(EXCLUDE_ANNOTATION) == "true"
        or MIRROR_POD_ANNOTATION in annotations
    )


def safe_to_apply(pod: dict, pds: list[dict]) -> None:
    """Raise MergeConflict unless every PodDefault merges cleanly
    (main.go:101-150). Pure — never mutates the pod."""
    apply_poddefaults(deepcopy(pod), pds)


def apply_poddefaults(pod: dict, pds: list[dict]) -> dict:
    """Merge ``pds`` into ``pod`` in place; returns the pod (main.go:480-597).

    Conflicts raise (the reference *rejects* the pod on conflict,
    main.go:672-681 — same here, surfaced as an admission error).
    """
    if not pds:
        return pod
    spec = pod.setdefault("spec", {})

    spec_merges = (
        ("volumes", "volumes", (lambda v: v.get("name"),)),
        ("tolerations", "tolerations", (lambda t: t.get("key"),)),
        ("imagePullSecrets", "imagePullSecrets", (lambda s: s.get("name"),)),
        ("initContainers", "initContainers", (lambda c: c.get("name"),)),
        ("sidecars", "containers", (lambda c: c.get("name"),)),
    )
    for field, target, keys in spec_merges:
        incoming = _collect(pds, field)
        if incoming:
            spec[target] = _merge_keyed(
                spec.get(target, []) or [], incoming, keys, field
            )

    meta = get_meta(pod)
    for field in ("labels", "annotations"):
        merged = _merge_map(meta.get(field) or {}, _collect_maps(pds, field), field)
        if merged:
            meta[field] = merged

    for pd in pds:
        sa = deep_get(pd, "spec", "serviceAccountName")
        if sa:
            spec["serviceAccountName"] = sa
        automount = deep_get(pd, "spec", "automountServiceAccountToken")
        if automount is not None:
            spec["automountServiceAccountToken"] = automount

    env_in = _collect(pds, "env")
    mounts_in = _collect(pds, "volumeMounts")
    envfrom_in = _collect(pds, "envFrom")
    sidecar_names = {name for _, c in _collect(pds, "sidecars") for name in [c.get("name")]}
    for ctr in spec.get("containers", []):
        if ctr.get("name") in sidecar_names:
            continue  # freshly injected sidecars carry their own env/mounts
        if env_in:
            ctr["env"] = _merge_keyed(
                ctr.get("env", []) or [], env_in, (lambda e: e.get("name"),), "env"
            )
        if mounts_in:
            ctr["volumeMounts"] = _merge_keyed(
                ctr.get("volumeMounts", []) or [],
                mounts_in,
                (lambda m: m.get("name"), lambda m: m.get("mountPath")),
                "volumeMounts",
            )
        if envfrom_in:
            ctr["envFrom"] = (ctr.get("envFrom", []) or []) + [
                deepcopy(item) for _, item in envfrom_in
            ]
        _set_command_and_args(ctr, pds)

    annotations = meta.setdefault("annotations", {})
    for pd in pds:
        annotations[f"{ANNOTATION_PREFIX}/poddefault-{name_of(pd)}"] = get_meta(
            pd
        ).get("resourceVersion", "")
    return pod


def _set_command_and_args(ctr: dict, pds: list[dict]) -> None:
    """Command/args fill-if-absent, istio sidecar excluded (main.go:583-597)."""
    if ctr.get("name") == ISTIO_PROXY_CONTAINER:
        return
    for pd in pds:
        command = deep_get(pd, "spec", "command")
        if ctr.get("command") is None and command is not None:
            ctr["command"] = list(command)
        args = deep_get(pd, "spec", "args")
        if ctr.get("args") is None and args is not None:
            ctr["args"] = list(args)


async def mutate_pod(kube, pod: dict) -> None:
    """Admission entrypoint: list PodDefaults in the pod's namespace, filter,
    check, apply (main.go:599-704). Registered as a Pod mutator."""
    if is_excluded(pod):
        return
    namespace = get_meta(pod).get("namespace")
    if not namespace:
        return
    pds = await kube.list("PodDefault", namespace)
    matching = filter_poddefaults(pds, pod)
    if not matching:
        return
    apply_poddefaults(pod, matching)  # raises MergeConflict → admission reject
