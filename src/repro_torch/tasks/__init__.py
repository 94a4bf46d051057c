"""repro_torch.tasks: the port's FL workloads.

    from repro_torch import tasks
    task = tasks.get("paper_mlp")
    td = task.build_data(seed=0)
    res = run_fleet_task(task, schemes, gains, task.run_config())

Built-in tasks register here (``token_stream``, the LM workload, with
the ``"steps"`` runtime of ``launch.train``); a workload plugs in by calling
``tasks.register(name, factory)`` with a factory returning a
:class:`~repro_torch.tasks.base.Task`.
"""
from repro_torch.tasks.base import Task, TaskData
from repro_torch.tasks.image import make_cifar_conv, make_paper_mlp
from repro_torch.tasks.lm import make_token_stream
from repro_torch.tasks.registry import get, names, register

register("paper_mlp", make_paper_mlp)
register("cifar_conv", make_cifar_conv)
register("token_stream", make_token_stream, runtime="steps")

__all__ = ["Task", "TaskData", "get", "names", "register", "make_cifar_conv",
           "make_paper_mlp", "make_token_stream"]
