"""Helpers over dict-shaped Kubernetes objects.

Objects are plain dicts everywhere (the Go stack's ``unstructured``), which
keeps the reference's central contract — a Notebook's ``spec.template.spec``
is a *literal PodSpec* (``notebook-controller/api/v1/notebook_types.go:27-34``)
— structurally true: every layer composes by editing the same dict.

The port's copy of ``kubeflow_tpu/runtime/objects.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import calendar
import copy
import time
from typing import Any

ISO_FORMAT = "%Y-%m-%dT%H:%M:%SZ"  # k8s RFC3339 second precision


def fmt_iso(ts: float) -> str:
    return time.strftime(ISO_FORMAT, time.gmtime(ts))


def fmt_iso_micro(ts: float) -> str:
    """metav1.MicroTime — microsecond RFC3339, the real precision of the
    Lease ``renewTime`` field. Leader election MUST use this: rounding a
    renew stamp down a whole second makes a fresh sub-second lease read
    as already expired, and mutual exclusion collapses (every candidate
    acquires)."""
    micros = int(round(ts * 1_000_000))
    secs, frac = divmod(micros, 1_000_000)
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(secs)) \
        + f".{frac:06d}Z"


def now_iso() -> str:
    return fmt_iso(time.time())


def parse_iso(value: str) -> float | None:
    # Fractional seconds are split off and re-added: strptime's %f parses
    # them but struct_time cannot carry them, so the old %f formats were
    # silently truncating MicroTime stamps to whole seconds.
    frac = 0.0
    if "." in value:
        head, _, tail = value.partition(".")
        digits = tail.rstrip("Zz")
        if digits.isdigit():
            frac = float(f"0.{digits}")
            value = head + "Z"
    try:
        return calendar.timegm(time.strptime(value, ISO_FORMAT)) + frac
    except ValueError:
        return None


def new_object(
    kind: str,
    name: str,
    namespace: str | None = None,
    *,
    api_version: str | None = None,
    labels: dict[str, str] | None = None,
    annotations: dict[str, str] | None = None,
    spec: Any = None,
) -> dict:
    from kubeflow_tpu_torch.runtime.scheme import DEFAULT_SCHEME

    meta: dict[str, Any] = {"name": name}
    if namespace is not None:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    obj: dict[str, Any] = {
        "apiVersion": api_version or DEFAULT_SCHEME.by_kind(kind).api_version,
        "kind": kind,
        "metadata": meta,
    }
    if spec is not None:
        obj["spec"] = spec
    return obj


def get_meta(obj: dict) -> dict:
    return obj.setdefault("metadata", {})


def name_of(obj: dict) -> str:
    return get_meta(obj).get("name", "")


def namespace_of(obj: dict) -> str | None:
    return get_meta(obj).get("namespace")


def uid_of(obj: dict) -> str | None:
    return get_meta(obj).get("uid")


def labels_of(obj: dict) -> dict:
    return get_meta(obj).setdefault("labels", {})


def annotations_of(obj: dict) -> dict:
    return get_meta(obj).setdefault("annotations", {})


def key_of(obj: dict) -> tuple[str | None, str]:
    return namespace_of(obj), name_of(obj)


def deep_get(obj: dict, *path: str, default: Any = None) -> Any:
    cur: Any = obj
    for part in path:
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def deep_set(obj: dict, *path_and_value: Any) -> None:
    *path, value = path_and_value
    cur = obj
    for part in path[:-1]:
        cur = cur.setdefault(part, {})
    cur[path[-1]] = value


def deepcopy(obj):
    """Deep copy for JSON-shaped trees (dict/list/scalars).

    K8s wire objects are acyclic and contain only these types, so the
    specialized walk skips copy.deepcopy's memo table and per-type
    dispatch — the fakekube read path (every get/list/watch hands out a
    copy) measured ~4× faster, which directly bounds control-plane
    reconcile throughput in the bench. Unexpected types (a test sticking a
    tuple or custom object into a spec) fall back to copy.deepcopy.
    """
    t = type(obj)
    if t is dict:
        return {k: deepcopy(v) for k, v in obj.items()}
    if t is list:
        return [deepcopy(v) for v in obj]
    if t is str or t is int or t is float or t is bool or obj is None:
        return obj
    return copy.deepcopy(obj)


# ---- owner references ---------------------------------------------------------------


def controller_owner(owner: dict) -> dict:
    """Build a controller ownerReference (blockOwnerDeletion like kubebuilder)."""
    return {
        "apiVersion": owner["apiVersion"],
        "kind": owner["kind"],
        "name": name_of(owner),
        "uid": uid_of(owner),
        "controller": True,
        "blockOwnerDeletion": True,
    }


def set_controller_owner(obj: dict, owner: dict) -> dict:
    refs = get_meta(obj).setdefault("ownerReferences", [])
    ref = controller_owner(owner)
    for existing in refs:
        if existing.get("uid") == ref["uid"]:
            existing.update(ref)
            return obj
    refs.append(ref)
    return obj


def owned_by(obj: dict, owner: dict) -> bool:
    uid = uid_of(owner)
    return any(r.get("uid") == uid for r in get_meta(obj).get("ownerReferences", []))


def controller_of(obj: dict) -> dict | None:
    for r in get_meta(obj).get("ownerReferences", []):
        if r.get("controller"):
            return r
    return None


# ---- label selectors ----------------------------------------------------------------


def matches_selector(labels: dict[str, str] | None, selector: dict | None) -> bool:
    """Evaluate a LabelSelector dict (matchLabels + matchExpressions).

    Mirrors the semantics the PodDefault webhook relies on
    (``admission-webhook/main.go:72-97`` label-selector filtering).
    """
    if not selector:
        return True  # empty selector matches everything
    labels = labels or {}
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key, op = expr.get("key"), expr.get("operator")
        values = expr.get("values") or []
        if op == "In":
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if labels.get(key) in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            return False
    return True


def parse_label_selector(selector: str | None) -> dict | None:
    """Parse a string selector ("a=b,c!=d,e") into LabelSelector dict form."""
    if not selector:
        return None
    match_labels: dict[str, str] = {}
    exprs: list[dict] = []
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            exprs.append({"key": k.strip(), "operator": "NotIn", "values": [v.strip()]})
        elif "==" in part:
            k, v = part.split("==", 1)
            match_labels[k.strip()] = v.strip()
        elif "=" in part:
            k, v = part.split("=", 1)
            match_labels[k.strip()] = v.strip()
        else:
            exprs.append({"key": part, "operator": "Exists"})
    out: dict = {}
    if match_labels:
        out["matchLabels"] = match_labels
    if exprs:
        out["matchExpressions"] = exprs
    return out or None


def selector_to_string(selector: str | dict | None) -> str | None:
    """Serialize a LabelSelector for the real apiserver's ?labelSelector=."""
    if selector is None or isinstance(selector, str):
        return selector
    parts: list[str] = []
    for k, v in (selector.get("matchLabels") or {}).items():
        parts.append(f"{k}={v}")
    for expr in selector.get("matchExpressions") or []:
        key, op = expr.get("key"), expr.get("operator")
        values = ",".join(expr.get("values") or [])
        if op == "In":
            parts.append(f"{key} in ({values})")
        elif op == "NotIn":
            parts.append(f"{key} notin ({values})")
        elif op == "Exists":
            parts.append(key)
        elif op == "DoesNotExist":
            parts.append(f"!{key}")
    return ",".join(parts) or None
