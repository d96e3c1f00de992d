"""The CalculationFramework: the paper's Project / Task programming model.

Python rendering of the paper's Appendix API:

    class IsPrimeTask(TaskBase):
        static_code_files = ["is_prime"]
        def run(self, input, static):
            return {"is_prime": static["is_prime"](input["candidate"])}

    class PrimeListMakerProject(ProjectBase):
        name = "PrimeListMakerProject"
        def run(self):
            task = self.create_task(IsPrimeTask)
            task.calculate([{"candidate": i} for i in range(1, 10001)])
            task.block(lambda results: ...)

Results arrive ordered by input index, "as if they were processed by the
local machine".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.distributor import Distributor, TaskDef


class TaskBase:
    """Subclass and override ``run``; list dataset keys in static_code_files."""

    static_code_files: Sequence[str] = ()

    @classmethod
    def task_name(cls) -> str:
        """Queue-visible task identifier (defaults to the class name)."""
        return cls.__name__

    def run(self, input: Any, static: dict) -> Any:  # noqa: A002
        """Execute one ticket's worth of work on a client (override)."""
        raise NotImplementedError


class TaskHandle:
    """A registered task plus the ticket ids of its in-flight inputs
    (returned by :meth:`CalculationFramework`-driven ``create_task``)."""

    def __init__(self, framework: "CalculationFramework", task_cls):
        self.framework = framework
        self.task_cls = task_cls
        self._ticket_ids: list[int] = []
        inst = task_cls()
        self.framework.distributor.register_task(TaskDef(
            name=task_cls.task_name(),
            run=inst.run,
            static_files=tuple(task_cls.static_code_files),
        ))

    def calculate(self, inputs: Sequence[Any]):
        """Divide the arguments into tickets and enqueue them (paper
        §2.1.1).  Goes through the distributor so tickets pin the task's
        registry coherence version (re-registering a task mid-run then
        invalidates browser caches via the pins)."""
        self._ticket_ids = self.framework.distributor.add_work(
            self.task_cls.task_name(), inputs)

    def block(self, callback: Optional[Callable] = None,
              timeout: Optional[float] = None):
        """Wait for all of THIS task's tickets; returns results ordered
        like the inputs ("as if processed by the local machine"), passing
        them to ``callback`` first when given.  Raises TimeoutError with
        the console snapshot if ``timeout`` elapses.  Uses the queue's
        O(round) ``results_for`` rather than copying the whole results
        table, so long-running multi-task projects don't pay for history."""
        ok = self.framework.distributor.queue.wait_all(timeout)
        if not ok:
            raise TimeoutError(
                f"tickets unfinished: {self.framework.distributor.console()}")
        ordered = self.framework.distributor.queue.results_for(
            self._ticket_ids)
        if ordered is None:       # wait_all raced a concurrent producer
            raise TimeoutError(
                f"tickets unfinished: {self.framework.distributor.console()}")
        if callback is not None:
            callback(ordered)
        return ordered


class ProjectBase:
    """Subclass and override :meth:`run`; orchestrates Tasks (paper
    appendix: ``PrimeListMakerProject``)."""

    name = "Project"

    def __init__(self, framework: "CalculationFramework"):
        self.framework = framework

    def create_task(self, task_cls) -> TaskHandle:
        """Register ``task_cls`` with the distributor and hand back its
        handle for ``calculate`` / ``block``."""
        return TaskHandle(self.framework, task_cls)

    def run(self):
        """Project entry point: create tasks, calculate, block (override)."""
        raise NotImplementedError


@dataclass
class CalculationFramework:
    """The paper's top-level object: couples a project to a Distributor
    and its HTTPServer-style static store."""

    distributor: Distributor

    def add_static(self, key: str, value: Any):
        """Publish a dataset/helper on the HTTPServer (versioned: a
        re-publish bumps the key and invalidates caches)."""
        self.distributor.add_static(key, value)

    def run_project(self, project_cls, *args, **kwargs):
        """Instantiate (if needed) and run a project; returns its result."""
        project = project_cls(self, *args, **kwargs) if not isinstance(
            project_cls, ProjectBase) else project_cls
        self.distributor.project_name = getattr(project, "name",
                                                project.__class__.__name__)
        return project.run()
