"""The port's controller runtime and fake apiserver behave as the
reference's: every case of tests/test_runtime.py and tests/test_fakekube.py
runs again with its imports pointed at ``kubeflow_tpu_torch`` (the
queue, the informer, the manager, apply, events, metrics, objects, the
fake apiserver's admission chain, watches, faults and the pod simulator),
asserts unchanged. Each reference case is one case here.
"""

import inspect

import pytest

from torch_control import ported, run_case

SOURCES = ("test_runtime.py", "test_fakekube.py")
MODULES = {name: ported(name) for name in SOURCES}
CASES = [(name, fn) for name, ns in MODULES.items()
         for fn in sorted(k for k, v in ns.items()
                          if k.startswith("test_") and callable(v))]


def test_every_reference_case_is_collected():
    assert len([c for c in CASES if c[0] == "test_runtime.py"]) == 26
    assert len([c for c in CASES if c[0] == "test_fakekube.py"]) == 14
    for ns in MODULES.values():
        assert ns["FakeKube"].__module__ == "kubeflow_tpu_torch.testing.fakekube"


@pytest.mark.parametrize("source,case", CASES,
                         ids=[f"{s[5:-3]}::{c}" for s, c in CASES])
def test_reference_case_on_the_port(source, case):
    fn = MODULES[source][case]
    assert not inspect.signature(fn).parameters, "fixtures are not ported"
    run_case(fn)


# ---- the port's own cases ---------------------------------------------------


@pytest.mark.parametrize("operation", ["CREATE", "UPDATE"])
def test_a_mutator_that_replaces_the_metadata_keeps_the_stamps(operation):
    """An admission mutator may replace the object's ``metadata`` (the
    facade applies a webhook's JSONPatch so): the stored object still gets
    its uid, a fresh resourceVersion and its generation, and a dependent's
    ownerReference by that uid is collected with it."""
    import asyncio
    import copy

    from kubeflow_tpu_torch.testing import FakeKube

    async def case():
        kube = FakeKube()

        def replace_metadata(obj, info):
            if info.get("operation") == operation:
                patched = copy.deepcopy(obj)
                patched["metadata"].setdefault("labels", {})["seen"] = "y"
                obj.clear()
                obj.update(patched)

        kube.add_mutator("ConfigMap", replace_metadata)
        cm = await kube.create("ConfigMap", {
            "metadata": {"name": "cm", "namespace": "ns"}, "data": {}})
        if operation == "UPDATE":
            before = cm["metadata"]["resourceVersion"]
            cm = await kube.update("ConfigMap", {**cm, "data": {"k": "v"}})
            assert int(cm["metadata"]["resourceVersion"]) > int(before)
        stored = await kube.get("ConfigMap", "cm", "ns")
        meta = stored["metadata"]
        assert meta["labels"] == {"seen": "y"}
        assert meta["uid"] and meta["resourceVersion"] == \
            cm["metadata"]["resourceVersion"] and meta["generation"] == 1
        await kube.create("Secret", {"metadata": {
            "name": "dep", "namespace": "ns", "ownerReferences": [
                {"kind": "ConfigMap", "name": "cm", "uid": meta["uid"]}]}})
        await kube.delete("ConfigMap", "cm", "ns")
        for _ in range(100):
            if await kube.get_or_none("Secret", "dep", "ns") is None:
                break
            await asyncio.sleep(0.01)
        assert await kube.get_or_none("Secret", "dep", "ns") is None

    asyncio.run(case())
