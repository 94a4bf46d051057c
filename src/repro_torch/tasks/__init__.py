"""repro_torch.tasks: the port's FL workloads.

    from repro_torch import tasks
    task = tasks.get("paper_mlp")
    td = task.build_data(seed=0)
    res = run_fleet_task(task, schemes, gains, task.run_config())

Built-in tasks register here; a workload plugs in by calling
``tasks.register(name, factory)`` with a factory returning a
:class:`~repro_torch.tasks.base.Task`.
"""
from repro_torch.tasks.base import Task, TaskData
from repro_torch.tasks.image import make_paper_mlp
from repro_torch.tasks.registry import get, names, register

register("paper_mlp", make_paper_mlp)

__all__ = ["Task", "TaskData", "get", "names", "register", "make_paper_mlp"]
