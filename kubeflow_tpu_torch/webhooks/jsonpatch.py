"""RFC 6902 JSON Patch generation (the port of
``kubeflow_tpu/webhooks/jsonpatch.py``).

The admission server must return the *difference* between the object the
apiserver sent and the mutated object (the reference marshals both and
diffs, ``admission-webhook/main.go:685-702`` via the jsonpatch lib). This
is that diff, from scratch: add/replace/remove ops, list-aware.
"""

from __future__ import annotations

from typing import Any


def _escape(token: str) -> str:
    return token.replace("~", "~0").replace("/", "~1")


def diff(old: Any, new: Any, path: str = "") -> list[dict]:
    """Minimal patch transforming ``old`` into ``new``."""
    if old == new:
        return []
    if isinstance(old, dict) and isinstance(new, dict):
        ops: list[dict] = []
        for key in old:
            if key not in new:
                ops.append({"op": "remove", "path": f"{path}/{_escape(str(key))}"})
        for key, value in new.items():
            sub = f"{path}/{_escape(str(key))}"
            if key not in old:
                ops.append({"op": "add", "path": sub, "value": value})
            else:
                ops.extend(diff(old[key], value, sub))
        return ops
    if isinstance(old, list) and isinstance(new, list):
        ops = []
        common = min(len(old), len(new))
        for i in range(common):
            ops.extend(diff(old[i], new[i], f"{path}/{i}"))
        # Removals from the tail, highest index first (indices shift on remove).
        for i in range(len(old) - 1, common - 1, -1):
            ops.append({"op": "remove", "path": f"{path}/{i}"})
        for i in range(common, len(new)):
            ops.append({"op": "add", "path": f"{path}/-", "value": new[i]})
        return ops
    return [{"op": "replace", "path": path or "", "value": new}]


def apply(doc: Any, patch: list[dict]) -> Any:
    """Reference applier (tests + dry-runs); raises on malformed patches."""
    import copy

    doc = copy.deepcopy(doc)

    def resolve(path: str) -> tuple[Any, str | int]:
        if not path.startswith("/"):
            raise ValueError(f"bad path {path!r}")
        parts = [p.replace("~1", "/").replace("~0", "~") for p in path[1:].split("/")]
        cur = doc
        for part in parts[:-1]:
            cur = cur[int(part)] if isinstance(cur, list) else cur[part]
        last = parts[-1]
        if isinstance(cur, list) and last != "-":
            return cur, int(last)
        return cur, last

    for op in patch:
        kind, path = op["op"], op["path"]
        container, key = resolve(path)
        if kind == "add":
            if isinstance(container, list):
                if key == "-":
                    container.append(op["value"])
                else:
                    container.insert(key, op["value"])
            else:
                container[key] = op["value"]
        elif kind == "replace":
            container[key] = op["value"]
        elif kind == "remove":
            if isinstance(container, list):
                container.pop(key)
            else:
                del container[key]
        else:
            raise ValueError(f"unsupported op {kind!r}")
    return doc
