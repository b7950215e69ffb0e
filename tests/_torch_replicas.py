"""A mesh whose ranks each sit on a device of their own, on the CPU, and the
check of the copies a model keeps of leaves read on another device
(``repro_torch.models.api.replica``).

``torch.device("cpu:1")`` is another device than ``"cpu"`` to the port's
placement (a leaf stored on one is copied to read on the other), while the
tensors on both live in host memory: a mesh over ``FOUR`` runs the code
paths of four cards on the CPU.
"""
import torch

FOUR = ("cpu", "cpu:1", "cpu:2", "cpu:3")


def check_replicas(owners, run) -> None:
    """The copies ``owners`` (modules) hold: there are some; ``run()`` again
    reuses each (made once a device); each equals its leaf as it is now,
    so an update has reached them."""
    reps = [o.__dict__.get("_replicas", {}) for o in owners]
    assert any(reps)
    before = [{k: v[2] for k, v in r.items()} for r in reps]
    run()
    leaves = {id(p): p for o in owners for p in o.parameters()}
    for r, b in zip(reps, before):
        assert set(r) == set(b) and all(r[k][2] is b[k] for k in b)
        for (pid, _), (_, _, copy) in r.items():
            assert torch.equal(copy, leaves[pid].detach())
