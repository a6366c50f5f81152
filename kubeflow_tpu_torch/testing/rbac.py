"""SubjectAccessReview evaluation for the fake apiserver (the port of
``kubeflow_tpu/testing/rbac.py``).

envtest delegates SARs to a real kube-apiserver; FakeKube needs its own
evaluator so the web apps' SarAuthorizer works against the RoleBindings
the profile controller materializes (reference authz flow:
crud_backend/authz.py SAR → RBAC). Registration is an admission mutator:
a created SubjectAccessReview gets ``status.allowed`` filled in before it
is stored, exactly like the apiserver's synchronous SAR semantics.

Verb model (the subset the web apps use): ``kubeflow-view`` grants
get/list/watch; ``kubeflow-edit`` and ``kubeflow-admin`` grant everything.
"""

from __future__ import annotations

from kubeflow_tpu_torch.runtime.objects import deep_get

READ_VERBS = {"get", "list", "watch"}
EDIT_ROLES = {"kubeflow-edit", "kubeflow-admin"}
VIEW_ROLES = {"kubeflow-view"}


def register_sar_evaluator(kube, *, cluster_admins: set[str] | None = None) -> None:
    admins = cluster_admins or set()

    async def evaluate(sar: dict, info: dict) -> None:
        if info.get("operation") != "CREATE":
            return
        spec = sar.get("spec") or {}
        user = spec.get("user") or ""
        attrs = spec.get("resourceAttributes") or {}
        verb = attrs.get("verb") or "get"
        ns = attrs.get("namespace")
        sar["status"] = {
            "allowed": await _allowed(kube, admins, user, verb, ns)
        }

    kube.add_mutator("SubjectAccessReview", evaluate)


async def _allowed(kube, admins: set[str], user: str, verb: str,
                   ns: str | None) -> bool:
    if user in admins:
        return True
    if not ns:
        return False
    # Profile owner of the namespace: full access (the profile controller
    # also materializes the admin RoleBinding, but owner-allow keeps the
    # window before reconcile finishes from 403ing the owner's first load).
    profile = await kube.get_or_none("Profile", ns)
    if profile is not None:
        owner = deep_get(profile, "spec", "owner", default={}) or {}
        if owner.get("name") == user:
            return True
    # RoleBindings in the namespace (KFAM contributor bindings + the
    # profile controller's owner binding).
    for rb in await kube.list("RoleBinding", ns):
        if not any(
            s.get("kind", "User") == "User" and s.get("name") == user
            for s in rb.get("subjects") or []
        ):
            continue
        role = deep_get(rb, "roleRef", "name", default="")
        if role in EDIT_ROLES:
            return True
        if role in VIEW_ROLES and verb in READ_VERBS:
            return True
    return False
