"""Export pipeline core (`fastforward_tpu/export/pipeline.py`): named
stages composed into a DAG, an execution context threaded through them, and
a registry of (target, format) → pipeline.

The built-in pipeline, ("gpu", "torch_export"), captures the golden output
under export mode, exports the program (`export/torch_export.py`: the
``.pt2``, its graph's code and the encodings JSON), and validates the
reloaded program against the golden output.
"""

import dataclasses
from typing import Any, Callable, Optional

from fastforward_tpu_torch.exceptions import ExportError


@dataclasses.dataclass
class ExportContext:
    """Mutable state threaded through pipeline stages."""

    model: Any
    sample_args: tuple
    output_dir: str
    name: str
    options: dict[str, Any] = dataclasses.field(default_factory=dict)
    artifacts: dict[str, Any] = dataclasses.field(default_factory=dict)


Stage = Callable[[ExportContext], None]


class Pipeline:
    """An ordered DAG of named stages. Stages may declare dependencies; the
    pipeline executes a topological order."""

    def __init__(self, name: str):
        self.name = name
        self._stages: dict[str, tuple[Stage, tuple[str, ...]]] = {}

    def add_stage(self, name: str, stage: Stage, after: tuple[str, ...] = ()) -> "Pipeline":
        if name in self._stages:
            raise ExportError(f"duplicate stage {name!r} in pipeline {self.name!r}")
        for dep in after:
            if dep not in self._stages:
                raise ExportError(f"stage {name!r} depends on unknown stage {dep!r}")
        self._stages[name] = (stage, tuple(after))
        return self

    def stage_order(self) -> list[str]:
        order: list[str] = []
        visiting: set[str] = set()

        def visit(name: str) -> None:
            if name in order:
                return
            if name in visiting:
                raise ExportError(f"cycle at stage {name!r}")
            visiting.add(name)
            for dep in self._stages[name][1]:
                visit(dep)
            visiting.discard(name)
            order.append(name)

        for name in self._stages:
            visit(name)
        return order

    # -- graph manipulation --

    def _check_known(self, name: str) -> None:
        if name not in self._stages:
            raise ExportError(f"No stage named {name!r} in pipeline {self.name!r}")

    def _dependents_of(self, target: str) -> list[str]:
        return [n for n, (_, deps) in self._stages.items() if target in deps]

    def insert_stage_before(
        self, target: str, stage: Stage, name: str,
        depends_on: Optional[tuple[str, ...]] = None,
    ) -> "Pipeline":
        """Splice ``stage`` in so it runs immediately before ``target``: by
        default it inherits ``target``'s dependencies and ``target`` is
        rewired to depend on it. Explicit ``depends_on`` wires the new
        stage only via the given names, leaving ``target`` untouched."""
        self._check_known(target)
        if name in self._stages:
            raise ExportError(f"duplicate stage {name!r} in pipeline {self.name!r}")
        fn, target_deps = self._stages[target]
        if depends_on is None:
            self._stages[name] = (stage, target_deps)
            self._stages[target] = (fn, (name,))
        else:
            for dep in depends_on:
                self._check_known(dep)
            self._stages[name] = (stage, tuple(depends_on))
        return self

    def insert_stage_after(self, target: str, stage: Stage, name: str) -> "Pipeline":
        """Insert ``stage`` immediately after ``target``: it depends on
        ``target`` and every former dependent of ``target`` is rewired to
        depend on the new stage (downstream sees its output)."""
        self._check_known(target)
        if name in self._stages:
            raise ExportError(f"duplicate stage {name!r} in pipeline {self.name!r}")
        for dep_name in self._dependents_of(target):
            fn, deps = self._stages[dep_name]
            self._stages[dep_name] = (
                fn, tuple(name if d == target else d for d in deps)
            )
        self._stages[name] = (stage, (target,))
        return self

    def replace_stage(self, target: str, stage: Stage) -> "Pipeline":
        """Swap ``target``'s callable in place (dependencies and dependents
        preserved) — the drop-in replacement form."""
        self._check_known(target)
        _, deps = self._stages[target]
        self._stages[target] = (stage, deps)
        return self

    def add_dependency(self, stage: str, dependency: str) -> "Pipeline":
        """Add a ``stage`` -> ``dependency`` edge (idempotent; cycles are
        rejected here rather than at run time)."""
        self._check_known(stage)
        self._check_known(dependency)
        fn, deps = self._stages[stage]
        if dependency in deps:
            return self
        self._stages[stage] = (fn, deps + (dependency,))
        try:
            self.stage_order()
        except ExportError:
            self._stages[stage] = (fn, deps)
            raise ExportError(
                f"adding dependency {dependency!r} to {stage!r} would "
                f"introduce a cycle"
            )
        return self

    def remove_dependency(self, stage: str, dependency: str) -> "Pipeline":
        """Remove the ``stage`` -> ``dependency`` edge."""
        self._check_known(stage)
        fn, deps = self._stages[stage]
        if dependency not in deps:
            raise ExportError(
                f"stage {stage!r} has no dependency {dependency!r}"
            )
        self._stages[stage] = (fn, tuple(d for d in deps if d != dependency))
        return self

    def run(self, context: ExportContext) -> ExportContext:
        for name in self.stage_order():
            stage, _ = self._stages[name]
            try:
                stage(context)
            except ExportError:
                raise
            except Exception as e:  # noqa: BLE001
                raise ExportError(f"stage {name!r} of pipeline {self.name!r} failed: {e}") from e
        return context


class PipelineRegistry:
    """(target, format) → pipeline factory.
    """

    def __init__(self) -> None:
        self._factories: dict[tuple[str, str], Callable[[], Pipeline]] = {}

    def register(self, target: str, format: str, factory: Callable[[], Pipeline]) -> None:
        self._factories[(target, format)] = factory

    def resolve(self, target: str, format: str) -> Pipeline:
        key = (target, format)
        if key not in self._factories:
            raise ExportError(
                f"No export pipeline for target={target!r} format={format!r}; "
                f"known: {sorted(self._factories)}"
            )
        return self._factories[key]()


# --- the built-in torch.export pipeline ---------------------------------------


def _stage_capture_golden(ctx: ExportContext) -> None:
    """Record the export-mode outputs the exported program is validated
    against."""
    import torch

    from fastforward_tpu_torch import flags

    with torch.no_grad(), flags.export_mode(True), flags.strict_quantization(False):
        out = ctx.model(*ctx.sample_args)
    ctx.artifacts["golden_output"] = out


def _stage_export_program(ctx: ExportContext) -> None:
    from fastforward_tpu_torch.export.torch_export import export as export_fn

    ctx.artifacts.update(export_fn(
        ctx.model, ctx.sample_args, ctx.output_dir, name=ctx.name,
        schema=ctx.options.get("schema", "v1"), lpbq=ctx.options.get("lpbq"),
    ))


def _stage_validate(ctx: ExportContext) -> None:
    """Reload the saved program and hold its outputs to the golden ones."""
    import torch
    from torch.utils import _pytree as pytree

    program = torch.export.load(ctx.artifacts["program"])
    with torch.no_grad():
        out = program.module()(*ctx.sample_args)
    for a, b in zip(pytree.tree_leaves(out), pytree.tree_leaves(ctx.artifacts["golden_output"])):
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise ExportError("exported program deviates from the golden output")
    ctx.artifacts["validated"] = True


def build_torch_export_pipeline() -> Pipeline:
    return (
        Pipeline("torch_export")
        .add_stage("capture_golden", _stage_capture_golden)
        .add_stage("export_program", _stage_export_program, after=("capture_golden",))
        .add_stage("validate", _stage_validate, after=("export_program",))
    )


def build_default_registry() -> PipelineRegistry:
    registry = PipelineRegistry()
    registry.register("gpu", "torch_export", build_torch_export_pipeline)
    return registry


def run_export_pipeline(
    model: Any,
    sample_args: tuple,
    output_dir: str,
    name: str = "model",
    target: str = "gpu",
    format: str = "torch_export",
    registry: Optional[PipelineRegistry] = None,
    **options: Any,
) -> ExportContext:
    """Resolve and run an export pipeline."""
    registry = registry or build_default_registry()
    pipeline = registry.resolve(target, format)
    context = ExportContext(
        model=model, sample_args=sample_args, output_dir=output_dir,
        name=name, options=options,
    )
    return pipeline.run(context)
