"""Inferencer (reference python/paddle/fluid/inferencer.py; the JAX
package's paddle_tpu/inferencer.py): build the inference program from a
function in test mode, load its parameters saved by fluid.io, and run it
— on one Executor, or with parallel=True on a ParallelExecutor — or serve
it (`serve()`)."""

import contextlib

from . import io as io_mod
from . import unique_name
from .core.framework import Program, program_guard
from .core.places import CUDAPlace
from .core.scope import Scope, scope_guard
from .executor import Executor
from .parallel_executor import ParallelExecutor
from .trainer import check_and_get_place

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(self, infer_func, param_path, place=None, parallel=False):
        self.param_path = param_path
        self._infer_func = infer_func
        self.scope = Scope()
        self.parallel = parallel
        self.place = check_and_get_place(place)

        program = Program()
        with program_guard(program):
            with unique_name.guard():
                predict_var = infer_func()
        # test mode, as the reference Inferencer clones it (batch_norm on
        # its running statistics, dropout off); the JAX package's
        # Inferencer runs the layers' training mode
        self.inference_program = program.clone(for_test=True)
        self.predict_var = self.inference_program.global_block().var(
            predict_var.name)

        with scope_guard(self.scope):
            self.exe = Executor(self.place)
            io_mod.load_params(self.exe, param_path, self.inference_program)

        if parallel:
            with self._prog_and_scope_guard():
                # the card flag follows the RESOLVED place: a CPUPlace
                # inferencer runs its ranks over gloo, not NCCL
                self.pe = ParallelExecutor(
                    use_cuda=isinstance(self.place, CUDAPlace),
                    main_program=self.inference_program,
                )

    def infer(self, inputs, return_numpy=True):
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        with self._prog_and_scope_guard():
            if self.parallel:
                results = self.pe.run(
                    feed=inputs, fetch_list=[self.predict_var.name],
                    return_numpy=return_numpy,
                )
            else:
                results = self.exe.run(
                    self.inference_program,
                    feed=inputs,
                    fetch_list=[self.predict_var],
                    return_numpy=return_numpy,
                )
        return results

    def serve(self, config=None, transpile=True, start=True):
        """A serve.Server over this inferencer's program and params.

        The server gets its own Program/Scope (built by from_infer_func
        from the same infer_func + param_path), so the transpiler's
        weight folding never mutates the inferencer's own state. With
        start=True the server comes back warmed and ready."""
        from .serve import Server

        server = Server.from_infer_func(
            self._infer_func, self.param_path, place=self.place,
            config=config, transpile=transpile)
        if start:
            server.start()
        return server

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with program_guard(main_program=self.inference_program):
            with scope_guard(self.scope):
                yield
