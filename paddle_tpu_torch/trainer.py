"""High-level Trainer (reference python/paddle/fluid/trainer.py:88; the JAX
package's paddle_tpu/trainer.py): event hooks, place selection,
train/test/save, Executor vs ParallelExecutor switching, the io-format
CheckpointConfig and the fault-tolerant loop of `resilience`.

`train(num_epochs, event_handler, reader, feed_order)` takes a reader of
batches (fed through a DataFeeder) or a datapipe.DataPipe (its staged
chunks fed straight to Executor.run, `iters` = the pipe's chunk). With a
ResilienceConfig both loops run under a ResilientRunner: restore at start
(params, optimizer state, the global step, the pipe's source position and
the program's random stream), retried dispatch, the NaN guard, the
checkpoint cadence and the grace save on SIGTERM/SIGINT. Under
PADDLE_TRAINING_ROLE (TRAINER or PSERVER, with the reference's
PADDLE_PSERVER_IPS, PADDLE_PSERVER_PORT, PADDLE_CURRENT_IP,
PADDLE_TRAINERS and PADDLE_TRAINER_ID) the programs are transpiled for a
parameter server (DistributeTranspiler), and a PSERVER's train() serves
until a trainer stops it. The JAX package's runner also resizes an
elastic fleet (Resized), which waits for the rest of the distributed
stack (ROADMAP queue 1 item 8) and raises here.
"""

import contextlib
import os

from . import io as io_mod
from . import monitor as monitor_mod
from .core.framework import Program, program_guard
from .core.places import CPUPlace, CUDAPlace, device_for
from .core.scope import Scope, scope_guard
from .data_feeder import DataFeeder
from .executor import Executor
from .optimizer import Optimizer
from .parallel_executor import ParallelExecutor

__all__ = [
    "Trainer", "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent",
    "EndStepEvent", "CheckpointConfig", "check_and_get_place",
]


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id, datapipe_stats=None):
        self.epoch = epoch_id
        # cumulative per-stage datapipe snapshot (busy/wait/backpressure
        # seconds, occupancy, bottleneck_stage) when the epoch was driven
        # by a DataPipe — None for reader/DataFeeder epochs
        self.datapipe_stats = datapipe_stats


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics, monitor=None):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics
        # paddle_tpu_torch.monitor step record of the run that produced
        # metrics (dict: total_ms, phases_ms, cache, ... — see
        # monitor/journal.py), or None when FLAGS_monitor=0
        self.monitor = monitor


class CheckpointConfig:
    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10):
        self.checkpoint_dir = checkpoint_dir or os.getcwd()
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval


def _pipe_stats(pipe):
    """Cumulative stage snapshot for EndEpochEvent — never lets a
    telemetry failure break the epoch boundary."""
    try:
        return pipe.stats()
    except Exception:
        return None


def check_and_get_place(place):
    """The place to run on: `place`, or the first CUDA card when it is
    None. The JAX package falls back to the CPU where it finds no
    accelerator; the port does not: with no card, None raises (through
    core.places.device_for), and only an explicit CPUPlace() runs on the
    host."""
    if place is None:
        place = CUDAPlace(0)
    device_for(place)
    return place


class Trainer:
    """reference trainer.py:88.

    Args:
        train_func: builds the cost program; returns loss (or [loss, ...]).
        optimizer_func: returns an Optimizer.
        place: where to run (the first CUDA card by default).
        parallel: run the reader loop through a ParallelExecutor.
        checkpoint_config: a CheckpointConfig (io-format checkpoints).
        resilience_config: a resilience.ResilienceConfig.
    """

    def __init__(self, train_func, optimizer_func, param_path=None, place=None,
                 parallel=False, checkpoint_config=None,
                 resilience_config=None):
        self.__stop = False
        self.parallel = parallel
        self.checkpoint_cfg = checkpoint_config
        self.resilience_cfg = resilience_config

        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()

        with program_guard(self.train_program, self.startup_program):
            program_func_outs = train_func()
            self.train_func_outputs = (
                program_func_outs
                if isinstance(program_func_outs, list)
                else [program_func_outs]
            )
            self.test_program = self.train_program.clone(for_test=True)
            optimizer = optimizer_func()
            if not isinstance(optimizer, Optimizer):
                raise TypeError(
                    "The optimizer should be an instance of Optimizer")
            loss = self.train_func_outputs[0]
            optimizer.minimize(loss, self.startup_program)

        self.place = check_and_get_place(place)
        self._dist_transpile_if_necessary()

        with scope_guard(self.scope):
            Executor(self.place).run(self.startup_program)

        if param_path and os.path.isdir(param_path):
            with scope_guard(self.scope):
                io_mod.load_persistables(
                    Executor(self.place), dirname=param_path,
                    main_program=self.startup_program,
                )
        if self.checkpoint_cfg and os.path.isdir(
                self.checkpoint_cfg.checkpoint_dir):
            with scope_guard(self.scope):
                io_mod.load_checkpoint(
                    Executor(self.place), self.checkpoint_cfg.checkpoint_dir,
                    self.train_program,
                )

        # fault-tolerant loop (resilience): retry/NaN-guard/preemption
        # handling plus async atomic checkpoints; the actual restore
        # happens at train() start, where the datapipe (whose source
        # position rides the manifest) and the Executor (whose random
        # stream does) are in hand
        self._resilience = None
        if resilience_config is not None:
            from .resilience import ResilientRunner

            self._resilience = ResilientRunner(
                resilience_config, scope=self.scope,
                program=self.train_program, place=self.place)

    def _dist_transpile_if_necessary(self):
        """Cluster bootstrap from the environment (reference
        trainer.py:148-196; the JAX package's, with its env names)."""
        if "PADDLE_TRAINING_ROLE" not in os.environ:
            return
        from .transpiler import DistributeTranspiler

        training_role = os.environ["PADDLE_TRAINING_ROLE"]
        port = os.environ.get("PADDLE_PSERVER_PORT", "6174")
        pserver_ips = os.environ.get("PADDLE_PSERVER_IPS", "")
        eplist = [f"{ip}:{port}" for ip in pserver_ips.split(",") if ip]
        trainers = int(os.environ.get("PADDLE_TRAINERS", "1"))
        trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        current_endpoint = (
            os.environ.get("PADDLE_CURRENT_IP", "127.0.0.1") + ":" + port)
        t = DistributeTranspiler()
        t.transpile(trainer_id, pservers=",".join(eplist), trainers=trainers,
                    program=self.train_program,
                    startup_program=self.startup_program)
        if training_role == "PSERVER":
            self.train_program = t.get_pserver_program(current_endpoint)
            self.startup_program = t.get_startup_program(
                current_endpoint, self.train_program)
        elif training_role == "TRAINER":
            self.train_program = t.get_trainer_program()
        else:
            raise ValueError("PADDLE_TRAINING_ROLE must be PSERVER or TRAINER")

    def stop(self):
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None, feed_order=None):
        if os.environ.get("PADDLE_TRAINING_ROLE", "") == "PSERVER":
            # serves until a trainer sends exit
            with scope_guard(self.scope):
                Executor(self.place).run(self.train_program)
            return
        self._train_by_executor(num_epochs, event_handler, reader, feed_order)

    def test(self, reader, feed_order):
        return self._test_by_executor(
            reader, feed_order, self.train_func_outputs
        )

    def save_params(self, param_path):
        with scope_guard(self.scope):
            exe = Executor(self.place)
            io_mod.save_persistables(exe, dirname=param_path,
                                     main_program=self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        with scope_guard(self.scope):
            exe = Executor(self.place)
            target_vars = [self.train_func_outputs[i]
                           for i in target_var_indexes]
            io_mod.save_inference_model(param_path, feeded_var_names,
                                        target_vars, exe, self.train_program)

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with program_guard(main_program=self.train_program,
                           startup_program=self.startup_program):
            with scope_guard(self.scope):
                yield

    def _get_or_make_feeder(self, feed_order):
        if feed_order is None:
            raise ValueError("feed_order is required")
        feed_var_list = [
            self.train_program.global_block().var(name) for name in feed_order
        ]
        return DataFeeder(feed_list=feed_var_list, place=self.place,
                          program=self.train_program)

    def _fetch(self, begin_event):
        return ([v.name for v in self.train_func_outputs]
                if begin_event.fetch_metrics else [])

    def _train_by_datapipe(self, num_epochs, event_handler, pipe):
        """Drive training straight off a datapipe.DataPipe: staged items
        are already device-resident feed dicts (no DataFeeder), and a
        chunked pipe (prefetch_to_device(chunk=K)) runs its K steps in one
        run per iteration (Executor.run iters=K)."""
        exe = Executor(self.place)
        iters = pipe.feed_iters
        if self._resilience is not None:
            self._train_by_datapipe_resilient(num_epochs, event_handler,
                                              pipe, exe, iters)
            return
        for epoch_id in range(num_epochs):
            event_handler(BeginEpochEvent(epoch_id))
            for step_id, staged in enumerate(pipe):
                if self.__stop:
                    pipe.close()
                    return
                begin_event = BeginStepEvent(epoch_id, step_id)
                event_handler(begin_event)
                metrics = exe.run(self.train_program, feed=staged,
                                  fetch_list=self._fetch(begin_event),
                                  iters=iters)
                snap = monitor_mod.last_step() \
                    if monitor_mod.enabled() else None
                event_handler(EndStepEvent(epoch_id, step_id, metrics,
                                           monitor=snap))
            event_handler(EndEpochEvent(
                epoch_id, datapipe_stats=_pipe_stats(pipe)))

    def _train_by_datapipe_resilient(self, num_epochs, event_handler, pipe,
                                     exe, iters):
        """The datapipe loop under a ResilientRunner: restore-at-start
        (params, step counter, mid-epoch source position, the program's
        random stream), retried step dispatch, NaN guard, checkpoint
        cadence, grace-save on SIGTERM/SIGINT (which re-raises
        resilience.Preempted). Step events carry the runner's GLOBAL step
        id — stable across restores, unlike a per-epoch index. The JAX
        package reseats its executor's step counter after a restore, from
        which it folds each step's random key; the port's stream is a
        generator whose state the checkpoint carries (runner.bind)."""
        from .resilience import RolledBack

        runner = self._resilience.bind(exe)
        with runner.session():
            runner.restore(pipe)
            epoch_id = int(runner.state.get("epoch", 0))
            while epoch_id < num_epochs:
                event_handler(BeginEpochEvent(epoch_id))
                try:
                    for staged in pipe:
                        if self.__stop:
                            pipe.close()
                            return
                        begin_event = BeginStepEvent(epoch_id,
                                                     runner.global_step)
                        event_handler(begin_event)
                        fetch = self._fetch(begin_event)
                        metrics = runner.run_step(
                            lambda: exe.run(self.train_program, feed=staged,
                                            fetch_list=fetch, iters=iters))
                        metrics = runner.after_step(
                            metrics, pipe=pipe, extra={"epoch": epoch_id})
                        snap = monitor_mod.last_step() \
                            if monitor_mod.enabled() else None
                        event_handler(EndStepEvent(
                            epoch_id, runner.global_step - 1, metrics,
                            monitor=snap))
                except RolledBack:
                    # scope, pipe and random stream re-seated on a
                    # checkpoint; re-enter the epoch loop from the
                    # restored position
                    epoch_id = int(runner.state.get("epoch", epoch_id))
                    continue
                event_handler(EndEpochEvent(
                    epoch_id, datapipe_stats=_pipe_stats(pipe)))
                epoch_id += 1
                # epoch boundary: the next pass starts at record 0
                runner.state["epoch"] = epoch_id

    def _train_by_executor(self, num_epochs, event_handler, reader,
                           feed_order):
        with self._prog_and_scope_guard():
            if hasattr(reader, "next_feed"):  # datapipe.DataPipe
                self._train_by_datapipe(num_epochs, event_handler, reader)
                return
            feeder = self._get_or_make_feeder(feed_order)
            exe = None
            if self.parallel:
                pe = ParallelExecutor(
                    use_cuda=not isinstance(self.place, CPUPlace),
                    loss_name=self.train_func_outputs[0].name,
                    main_program=self.train_program,
                )
                run = lambda feed, fetch: pe.run(fetch_list=fetch, feed=feed)
            else:
                exe = Executor(self.place)
                run = lambda feed, fetch: exe.run(
                    self.train_program, feed=feed, fetch_list=fetch
                )
            runner = self._resilience
            if runner is not None:
                if exe is not None:
                    runner.bind(exe)
                self._reader_loop_resilient(num_epochs, event_handler,
                                            reader, feeder, run, runner)
                return
            step = 0
            for epoch_id in range(num_epochs):
                event_handler(BeginEpochEvent(epoch_id))
                for step_id, data in enumerate(reader()):
                    if self.__stop:
                        return
                    begin_event = BeginStepEvent(epoch_id, step_id)
                    event_handler(begin_event)
                    metrics = run(feeder.feed(data), self._fetch(begin_event))
                    snap = monitor_mod.last_step() \
                        if monitor_mod.enabled() else None
                    event_handler(EndStepEvent(epoch_id, step_id, metrics,
                                               monitor=snap))
                    step += 1
                    if (
                        self.checkpoint_cfg
                        and step % self.checkpoint_cfg.step_interval == 0
                    ):
                        io_mod.save_checkpoint(
                            Executor(self.place),
                            self.checkpoint_cfg.checkpoint_dir,
                            self.checkpoint_cfg.max_num_checkpoints,
                            0,
                            self.train_program,
                        )
                event_handler(EndEpochEvent(epoch_id))

    def _reader_loop_resilient(self, num_epochs, event_handler, reader,
                               feeder, run, runner):
        """Reader path under a ResilientRunner. A plain reader has no
        seekable source position, so restore resumes params + step counter
        but replays the current epoch's records from its start (use a
        datapipe for exact mid-epoch resume); a nan_policy=restore
        rollback likewise restarts the epoch at the checkpoint's params."""
        from .resilience import RolledBack

        with runner.session():
            runner.restore()
            epoch_id = int(runner.state.get("epoch", 0))
            while epoch_id < num_epochs:
                event_handler(BeginEpochEvent(epoch_id))
                try:
                    for step_id, data in enumerate(reader()):
                        if self.__stop:
                            return
                        begin_event = BeginStepEvent(epoch_id, step_id)
                        event_handler(begin_event)
                        fetch = self._fetch(begin_event)
                        feed = feeder.feed(data)
                        metrics = runner.run_step(lambda: run(feed, fetch))
                        metrics = runner.after_step(
                            metrics, extra={"epoch": epoch_id})
                        snap = monitor_mod.last_step() \
                            if monitor_mod.enabled() else None
                        event_handler(EndStepEvent(epoch_id, step_id,
                                                   metrics, monitor=snap))
                except RolledBack:
                    epoch_id = int(runner.state.get("epoch", epoch_id))
                    continue
                event_handler(EndEpochEvent(epoch_id))
                epoch_id += 1
                runner.state["epoch"] = epoch_id

    def _test_by_executor(self, reader, feed_order, fetch_list):
        with scope_guard(self.scope):
            feeder = self._get_or_make_feeder(feed_order)
            exe = Executor(self.place)
            accumulated = len(fetch_list) * [0]
            count = 0
            for data in reader():
                outs = exe.run(
                    program=self.test_program,
                    feed=feeder.feed(data),
                    fetch_list=[v.name for v in fetch_list],
                )
                accumulated = [x[0] + x[1][0]
                               for x in zip(accumulated, outs)]
                count += 1
            return [x / count for x in accumulated]
