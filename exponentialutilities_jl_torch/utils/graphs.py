"""Loop programs over device tensors, replayed from CUDA graphs: the
port's counterpart of ``jax.jit`` for the drivers whose JAX form is one
compiled ``lax.while_loop`` or ``lax.scan`` program (``nw_device``,
``kiops_device``, the ``*_device`` integrators, the Krylov builders, the
fused sweeps' Lanczos passes and the fixed NW stepper).

A loop is a set of steps: functions of no arguments that read the loop's
state (tensors made before the loop, on the caller's stream) and write it
in place, every write masked by the state's own flags, so that a step run
after the loop has ended, or a step of the wrong kind, changes nothing.
The steps keep a 1-D ``flags`` tensor up to date; the host reads it to
choose the next step and to see the loop end.

``LoopRunner.loop`` runs one loop at one key (a Krylov bucket; the steps
of one key share their shapes), ``LoopRunner.repeat`` runs one step a
fixed number of times (a fixed-step scan) with no read at all. With
``last=True`` those are the step's last executions in the runner (a
Krylov builder's m steps, ``ops/krylov.py``): a step that would not run
again after its captured execution (a count of 2 or less) runs eagerly
instead of being captured.

Nested loops. A loop that a step runs (a builder inside a device
driver's step) runs inline, in the enclosing step, with no runner of its
own: ``inline`` says when, which is while any runner executes a step (its
warm-up, its capture or an eager run) and while the current CUDA stream
is capturing (a caller's own graph). The enclosing step's warm-up and
its capture then run the same kernels, and its counts stay its own.

On a CUDA device each step of a key is run once eagerly on the runner's
side stream (its warm-up: the kernel library is built, launch plans are
made and the BLAS and solver handles get their workspaces outside the
capture; the warm-up is the loop's first execution of that step, not a
throwaway run). At its second execution it is captured into a
``torch.cuda.CUDAGraph`` and replayed, then replayed from then on (a step
run once is never captured). A capture that fails raises a RuntimeError
naming the step; there is no eager fallback. A step must therefore not
read the device (``.item()``, ``.tolist()``, ``float()``, ``int()`` or
``bool()`` of a device tensor, ``torch.nonzero``, boolean indexing) nor
build a tensor from host data. The graphs belong to the runner, which
lives for one driver call (``with LoopRunner(...)``): they are freed when
it closes. Every runner of a device uses one side stream and captures
into one memory pool (``_shared``): graphs run one after another on that
stream, and a step's temporaries live within its execution, so a capture
reuses what earlier graphs freed. Graphs alive at once (the buckets of
one loop, a runner opened while another one lives) may therefore be
replayed in any order: none leaves a live tensor in the pool, since the
state is made before the loop, outside it. (A pool of its own per runner would be
handed back only when an allocation fails outside a capture: the
builders' thousands of graphs filled the card that way, and an
allocation inside a capture cannot free cached memory.)

Read cadence. After every execution the flags are copied without
blocking into pinned host memory and an event is recorded; the host waits
on the event of execution k only after it has enqueued execution k + 1,
and chooses execution k + 2 from the flags of execution k. So within a
loop the device never waits for the host, and the loop's end costs one
masked execution more. The read that ends a loop is counted as a blocking
read (after it the device has at most that masked execution left); the
others as flag reads.

Eager runs. On the CPU (the tests' device path), inside ``eager()`` and
for an operator sharded over a communicator (its collectives run on gloo,
which a graph cannot capture) the same steps run eagerly with the same
cadence, on the caller's stream. (Steps that autograd or a ``torch.func``
transform must see open no runner: ``ops/krylov.py`` runs them itself.) A sharded loop
reads its flags after every step (each read a blocking one), so that it
runs no step past its end: its collective counts are those of the host
loops.

Programs. ``Program`` is the counterpart of a jitted serving closure (the
JAX package's ``make_expv`` / ``make_phiv``): a whole call, a function of
static device inputs, captured into one graph per key and replayed. It
belongs to its closure and lives as long as it does (``close`` frees the
graphs earlier). The first call of a key runs eagerly (the warm-up: the
kernels are built, plans made, the BLAS and solver handles get their
workspaces), with every loop inside it inline, and records the tensors
from outside the call that it reads (the operator's, a parameter that a
user function closes over: ``_Touched``). If its result requires grad or
is wrapped by a ``torch.func`` transform, the key stays eager for good.
The second call is captured on the side stream into the shared pool and
replayed; from the third on, the inputs are copied into the key's static
inputs (made outside the capture, as is the output) and the graph
replayed, and the call returns a clone of the static output, so two
results never alias. Every call is first held to the grad rule: if
autograd or a ``torch.func`` transform must see it now (an input or a
recorded tensor requires grad in grad mode, is wrapped by a transform or
carries a forward-mode tangent, or a transform or a dual level is active:
``_sees_grad_now``), it runs eagerly, whatever the key has captured, so
a parameter that starts to require grad after the capture gets its
gradient. The CPU, ``eager()`` and a sharded operator run every call
eagerly. A program counts its eager calls in ``eager_steps``, its
capture in ``captures`` and the calls it served by replaying an existing
graph in ``replays`` (the capturing call's own replay is part of its
capture, but its kernel executions are counted).

Scans. ``Scan`` is a ``Program`` whose call is one step repeated a fixed
number of times over state made from the inputs (the JAX package's
jitted ``lax.scan`` closure, ``make_phiv_timestep``'s ``fn(B)``): its
graph is the step, not the whole call, so that it does not grow with the
count. ``make(*inputs)`` returns the scan (``ScanParts``: the state, with
the ``rebind`` flag of ``ops/krylov._State``, the step, the count, the
result and the restart that resets the state from the inputs). The first
call of a key is its warm-up: it makes the scan from the key's static
inputs, and ``run_scan`` executes its first step rebinding the state
(which sets the state's dtypes, and shows whether autograd must see the
call), then, where the state sees no grad, the rest through a
``LoopRunner`` that the key keeps: the step is captured at its second
execution, and the rest of that call and every later call replay it. A
later call copies its inputs into the static inputs, restarts the state
and replays the step ``count`` times, with no capture and no read, and
returns a clone of the result. The grad rule, the CPU, ``eager()`` and a
sharded operator run a call eagerly (a scan made from the call's own
inputs, its steps with no runner), and the record of "Stale storage"
below holds for the key as for a ``Program``'s.

Stale storage. A graph replays the pointers of its capture, while the
JAX package's closure is handed the operator on every call, so that it
follows the operator's current storage. So a program keeps, for each
key, a record of what its call reads from outside it, made after the
warm-up and again after the capture: the tensors that ``_Touched``
recorded, and those the program's owner (``holds``: the closure's
operator) holds now, each by its path of attributes (``held_tensors``),
each with its identity and its ``_version`` (a replay bumps no
version). Before the capture and before every replay the record is held
against the tensors now (``stale``): if a recorded tensor has died or
changed in place, or a path leads to another tensor (an attribute on it
reassigned), the key's graph is dropped (``recaptures`` counts it), the
call runs as the key's warm-up, eagerly, where the operator rebuilds
what it derives from its storage (launch plans, cast copies), and the
next call is captured anew. Not seen: a tensor attribute added to the
operator after the record, and a closure cell of a user function
reassigned to another tensor (a tensor it closes over is in the record).
The check reads no device: a few attribute reads and versions a tensor.

``counts`` tallies, per process, what the runners did (``captures``,
``replays``, ``eager_steps``, ``loops``, ``blocking_reads``,
``flag_reads``),
``executions`` each step's executions by (driver, key, step name),
``step_launches`` the kernel launches of each step's warm-up and of its
graph (by (driver, key, step name, "eager" or "graph")), and
``kernel_executions`` turns the kernels' host launch counters
(``ops/kernels/_build.launches``, which count a captured launch once and
a replay never) into executions: captured launches out, captured
launches times replays in.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref

import torch
import torch.autograd.forward_ad as fwAD
from torch.overrides import TorchFunctionMode

__all__ = ["LoopRunner", "Program", "Scan", "ScanParts", "run_scan",
           "eager", "inline", "masked_copy",
           "counts", "executions", "step_launches", "reset_counts",
           "launch_adjustment", "kernel_executions", "sees_grad",
           "held_tensors"]

counts = collections.Counter()
executions = collections.Counter()
step_launches = {}
# kernel launches recorded while capturing (counted by the host counters,
# never run as such) and those run by replays
_captured = collections.Counter()
_replayed = collections.Counter()
_eager_only = [False]
_in_step = [0]          # runner steps executing now (module doc: nesting)
_shared = {}            # CUDA device -> (side stream, pool id, anchor graph)


def reset_counts():
    counts.clear()
    executions.clear()
    step_launches.clear()
    _captured.clear()
    _replayed.clear()


def launch_adjustment() -> dict:
    """Per kernel, replayed launches less captured ones, so far."""
    return {k: _replayed[k] - _captured[k]
            for k in set(_captured) | set(_replayed)}


def kernel_executions(launches, since=None) -> dict:
    """Executions per kernel (every key of ``launches`` kept) from host
    launch counters: ``_build.launches`` since the last ``reset_counts``,
    or the difference of two of its snapshots with ``since`` the
    ``launch_adjustment()`` taken at the first."""
    adj, since = launch_adjustment(), since or {}
    keys = set(launches) | set(adj)
    return {k: launches.get(k, 0) + adj.get(k, 0) - since.get(k, 0)
            for k in keys}


@contextlib.contextmanager
def eager():
    """Run every loop step eagerly, also on a CUDA device (the graph
    versus eager comparison)."""
    prev, _eager_only[0] = _eager_only[0], True
    try:
        yield
    finally:
        _eager_only[0] = prev


def inline(device) -> bool:
    """A loop on ``device`` started now runs inline (module doc: a
    runner's step is executing, or the current CUDA stream is
    capturing)."""
    if _in_step[0]:
        return True
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _device_key(device):
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _side(device):
    """(side stream, graph memory pool id) of every runner on ``device``
    (module doc). The pool lives as long as one graph captured into it
    does (in the device and the pinned host allocator alike): a one-node
    anchor graph, made here and never freed, keeps it for the process. A
    capture that fails leaves its pool recording (the allocator's end of a
    capture never runs), so ``_capture`` drops the pair and the next
    runner makes a new one."""
    device = _device_key(device)
    got = _shared.get(device)
    if got is None:
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            pool = torch.cuda.graph_pool_handle()
            anchor = torch.cuda.CUDAGraph()
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                anchor.capture_begin(pool=pool)
                torch.zeros(1, device=device)
                anchor.capture_end()
        got = _shared[device] = (stream, pool, anchor)
    return got[:2]


def _run_step(fn):
    _in_step[0] += 1
    try:
        fn()
    finally:
        _in_step[0] -= 1


def masked_copy(dst, mask, val):
    """dst <- val where ``mask`` (a bool tensor broadcast against dst), in
    place: the write of a loop step, a no-op where the mask is off."""
    dst.copy_(torch.where(mask, val, dst))


def _launch_counts():
    from ..ops.kernels import _build
    return dict(_build.launches)


def _capture(device, pool, fn, what: str):
    """(graph, kernel launches recorded) of ``fn`` captured on the current
    (side) stream into ``pool``. A failed capture raises, naming ``what``
    (module doc); its pool is dropped (``_side``)."""
    before = _launch_counts()
    g = torch.cuda.CUDAGraph()
    err = None
    g.capture_begin(pool=pool)
    try:
        _run_step(fn)
    except Exception as e:          # noqa: BLE001 - re-raised below
        err = e
    try:
        g.capture_end()
    except Exception as e:          # noqa: BLE001 - re-raised below
        err = err or e
    if err is not None:
        _shared.pop(_device_key(device), None)
        raise RuntimeError(
            f"{what} into a CUDA graph failed ({type(err).__name__}: "
            f"{err}). A step must not read the device (.item(), "
            ".tolist(), float(), int() or bool() of a CUDA tensor, "
            "torch.nonzero, boolean indexing) nor build a tensor from host "
            "data; a user function called inside the step (f, N, a "
            "matvec) must follow the same rule, or run the call under "
            "exponentialutilities_jl_torch.utils.graphs.eager()") from err
    after = _launch_counts()
    inside = {k: after[k] - before.get(k, 0) for k in after
              if after[k] != before.get(k, 0)}
    _captured.update(inside)
    counts["captures"] += 1
    return g, inside


@contextlib.contextmanager
def _on_side(stream, device):
    """Run on ``stream`` (None: the caller's), ordered after the caller's
    work before and before it after."""
    if stream is None:
        yield
        return
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        caller.wait_stream(stream)


class LoopRunner:
    """Runs the steps of one driver call (module doc). ``what`` names the
    driver in errors; ``sharded``: the operator carries a communicator
    (its steps run eagerly, each followed by a read)."""

    def __init__(self, what: str, device, *, sharded: bool = False):
        self.what = what
        self.device = torch.device(device)
        self.graphed = (self.device.type == "cuda" and not sharded
                        and not _eager_only[0])
        self.lag = 0 if sharded else 1
        self.stream, self.pool = (_side(self.device) if self.graphed
                                  else (None, None))
        self.graphs = {}
        self.launches = {}
        self.warm = set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Free the graphs (a graph still running is destroyed when it
        completes); their memory goes back to the shared pool."""
        for g in self.graphs.values():
            g.reset()
        self.graphs.clear()

    def read(self, *tensors):
        """One blocking read of 0-d tensors: their host values."""
        counts["blocking_reads"] += 1
        vals = torch.stack([t.detach().to(torch.float64).reshape(())
                            for t in tensors]).tolist()
        return vals

    def _capture(self, key, name, fn):
        g, inside = _capture(self.device, self.pool, fn,
                             f"{self.what}: capturing its {name!r} step")
        self.launches[(key, name)] = inside
        step_launches[(self.what, key, name, "graph")] = inside
        return g

    def _execute(self, key, name, fn, capture: bool = True):
        executions[(self.what, key, name)] += 1
        g = self.graphs.get((key, name)) if self.graphed else None
        if g is not None:
            g.replay()
            counts["replays"] += 1
            _replayed.update(self.launches[(key, name)])
            return
        if self.graphed and capture and (key, name) in self.warm:
            self.graphs[(key, name)] = self._capture(key, name, fn)
            self._execute(key, name, fn)
            executions[(self.what, key, name)] -= 1
            return
        before = _launch_counts()
        _run_step(fn)
        counts["eager_steps"] += 1
        if (key, name) not in self.warm:
            after = _launch_counts()
            step_launches[(self.what, key, name, "eager")] = {
                k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
        self.warm.add((key, name))

    def _post(self, flags):
        """The flags of the execution just enqueued, on their way to the
        host: (event, pinned host copy) when graphed, else (None, a copy
        that the read below syncs on)."""
        if self.stream is None:
            return None, flags.detach().clone()
        buf = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        buf.copy_(flags.detach(), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev, buf

    def loop(self, key, steps: dict, flags, choose, first: str):
        """Execute ``steps`` (name -> function) from ``first`` until
        ``choose`` ends the loop: ``choose(host_flags)`` names the next
        step from a read of ``flags`` (None before any read: a guess) or
        returns None when those flags show the loop ended. Returns the
        host flags (a list of floats) of the read that ended it."""
        counts["loops"] += 1
        inflight = collections.deque()
        name = first
        with _on_side(self.stream, self.device):
            while True:
                self._execute(key, name, steps[name])
                inflight.append(self._post(flags))
                if len(inflight) <= self.lag:
                    name = choose(None)
                    continue
                ev, buf = inflight.popleft()
                if ev is not None:
                    ev.synchronize()
                host = buf.tolist()
                name = choose(host)
                if name is None or self.lag == 0:
                    counts["blocking_reads"] += 1
                else:
                    counts["flag_reads"] += 1
                if name is None:
                    return host

    def repeat(self, key, name: str, fn, count: int, *, last: bool = False):
        """Execute the step ``fn`` ``count`` times with no read. ``last``:
        these are its last executions in this runner, so it is captured
        only where at least one execution follows the captured one."""
        with _on_side(self.stream, self.device):
            for i in range(count):
                self._execute(key, name, fn,
                              capture=not last or count - i >= 2)


def sees_grad(tensors) -> bool:
    """Whether autograd or a ``torch.func`` transform must see a
    computation on ``tensors``: one requires grad, is wrapped by a
    transform or carries a forward-mode tangent (non-tensors skipped)."""
    return any(
        isinstance(t, torch.Tensor)
        and (t.requires_grad
             or torch._C._functorch.is_functorch_wrapped_tensor(t)
             or fwAD.unpack_dual(t).tangent is not None)
        for t in tensors)


def _sees_grad_now(tensors) -> bool:
    """The grad rule of a program call (module doc): a ``torch.func``
    transform or a forward-mode dual level is active, or one of
    ``tensors`` is wrapped by a transform, carries a tangent or, in grad
    mode, requires grad."""
    if (torch._C._functorch.peek_interpreter_stack() is not None
            or fwAD._current_level >= 0):
        return True
    grad = torch.is_grad_enabled()
    return any(
        (grad and t.requires_grad)
        or torch._C._functorch.is_functorch_wrapped_tensor(t)
        or fwAD.unpack_dual(t).tangent is not None
        for t in tensors if isinstance(t, torch.Tensor))


class _Touched(TorchFunctionMode):
    """While active, records the tensors that torch functions read and
    that no torch function made while it was active: what a call reads
    from outside it (module doc). Only weak references are kept, so no
    tensor lives longer for it."""

    def __init__(self):
        super().__init__()
        self.made = weakref.WeakValueDictionary()
        self.outside = {}

    def _see(self, x):
        if isinstance(x, torch.Tensor) and self.made.get(id(x)) is not x:
            self.outside[id(x)] = weakref.ref(x)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for x in (*args, *kwargs.values()):
            if isinstance(x, (list, tuple)):
                for y in x:
                    self._see(y)
            else:
                self._see(x)
        out = func(*args, **kwargs)
        for y in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(y, torch.Tensor):
                self.made[id(y)] = y
        return out

    def refs(self, skip=()):
        """Weak references to the recorded tensors, less ``skip`` (the
        call's inputs, which each call passes anew)."""
        skip = {id(x) for x in skip}
        return [r for k, r in self.outside.items() if k not in skip]


_PACKAGE = __name__.split(".")[0]


def _held(obj, depth: int = 4) -> list:
    """(path, tensor) of every tensor ``obj`` holds now, in a fixed order:
    its public attributes (no leading underscore: caches are skipped),
    followed into lists, tuples, dicts and objects of this package,
    ``depth`` levels deep (an operator's diagonals, a SELL pack's arrays,
    an inner or wrapped operator's storage). A path is a tuple of steps,
    (True, name) an attribute and (False, key) an item."""
    out, seen = [], set()

    def walk(x, path, d):
        if isinstance(x, torch.Tensor):
            out.append((path, x))
            return
        if d == 0 or id(x) in seen:
            return
        if isinstance(x, (list, tuple)):
            items = [((False, i), y) for i, y in enumerate(x)]
        elif isinstance(x, dict):
            items = [((False, k), y) for k, y in x.items()]
        elif type(x).__module__.split(".")[0] == _PACKAGE and hasattr(
                x, "__dict__"):
            seen.add(id(x))
            items = [((True, k), y) for k, y in vars(x).items()
                     if not k.startswith("_")]
        else:
            return
        for step, y in items:
            walk(y, path + (step,), d - 1)

    walk(obj, (), depth)
    return out


def held_tensors(obj, depth: int = 4) -> list:
    """The tensors ``obj`` holds now, in a fixed order (``_held``)."""
    return [t for _, t in _held(obj, depth)]


def _resolve(obj, path):
    for attr, key in path:
        obj = getattr(obj, key) if attr else obj[key]
    return obj


def _version(t):
    # an inference tensor keeps no version counter
    return None if t.is_inference() else t._version


def _clone(x):
    if isinstance(x, tuple):
        return tuple(t.clone() for t in x)
    return x.clone()


class Program:
    """A whole call of a closure, captured into one CUDA graph per key and
    replayed (module doc, "Programs"). ``what`` names the closure and its
    operator in errors; ``sharded``: the operator carries a communicator
    (every call runs eagerly); ``holds``: the object (the operator) whose
    tensors every call must read as they are now (module doc, "Stale
    storage"). It lives as long as its owner: ``close`` frees its graphs,
    and so does the owner's going (the graphs go with the program)."""

    def __init__(self, what: str, *, sharded: bool = False, holds=None):
        self.what = what
        self.sharded = sharded
        self.holds = holds
        # key -> (graph, static inputs, output, captured launches)
        self.graphs = {}
        # key -> weak references to the tensors from outside the call that
        # its warm-up read
        self.touched = {}
        # key -> ([(weak reference, version)] of the touched tensors, the
        # same of ``held_tensors(holds)``): the record (module doc)
        self.records = {}
        self.eager_keys = set()

    def close(self):
        """Free the graphs; their memory goes back to the shared pool."""
        for g, *_ in self.graphs.values():
            g.reset()
        self.graphs.clear()

    def record(self, key):
        """Record what the key's call reads from outside it, as it stands
        now (module doc, "Stale storage"): each tensor the owner holds by
        its path, and the touched tensors it does not hold."""
        held = _held(self.holds)
        ids = {id(t) for _, t in held}
        touched = [t for t in (r() for r in self.touched[key])
                   if t is not None and id(t) not in ids]
        self.records[key] = (
            [(weakref.ref(t), _version(t)) for t in touched],
            [(p, weakref.ref(t), _version(t)) for p, t in held])

    def stale(self, key) -> bool:
        """Whether the key's record no longer holds: a recorded tensor died
        or changed in place, or a path of the owner leads to another
        tensor now (an attribute reassigned) or to none."""
        touched, held = self.records[key]
        for r, v in touched:
            t = r()
            if t is None or (v is not None and t._version != v):
                return True
        for path, r, v in held:
            try:
                t = _resolve(self.holds, path)
            except (AttributeError, LookupError, TypeError):
                return True
            if t is not r() or (v is not None and t._version != v):
                return True
        return False

    def _drop(self, key):
        """Forget the key's graph and record: its next call is a warm-up."""
        got = self.graphs.pop(key, None)
        if got is not None:
            got[0].reset()
        self.touched.pop(key, None)
        self.records.pop(key, None)
        counts["recaptures"] += 1

    def __call__(self, key, fn, inputs: tuple):
        """``fn(*inputs)`` for device tensors ``inputs`` (module doc): the
        first call of a key eagerly, its second captured (and replayed),
        every later one replayed after ``inputs`` are copied into the
        key's static inputs; the result of a replay is a fresh clone. A
        call that the grad rule must see runs eagerly."""
        device = inputs[0].device
        graphed = (device.type == "cuda" and not self.sharded
                   and not _eager_only[0] and key not in self.eager_keys)
        if graphed and key in self.touched and self.stale(key):
            self._drop(key)
        if graphed and key in self.touched and not _sees_grad_now(
                (*inputs, *(r() for r in self.touched[key]))):
            got = self.graphs.get(key)
            if got is None:
                return self._capture(key, fn, inputs, device)
            g, static, out, inside = got
            stream, _ = _side(device)
            with _on_side(stream, device), torch.no_grad():
                for s, x in zip(static, inputs):
                    s.copy_(x)
                g.replay()
            counts["replays"] += 1
            _replayed.update(inside)
            return _clone(out)
        out = []
        if key in self.touched:
            _run_step(lambda: out.append(fn(*inputs)))
            counts["eager_steps"] += 1
            return out[0]
        with _Touched() as rec:         # the key's warm-up
            _run_step(lambda: out.append(fn(*inputs)))
        counts["eager_steps"] += 1
        self.touched[key] = rec.refs(skip=inputs)
        self.record(key)
        res = out[0]
        if sees_grad(res if isinstance(res, tuple) else (res,)):
            self.eager_keys.add(key)
        return res

    def _capture(self, key, fn, inputs, device):
        # inputs and outputs live outside the capture's temporaries: the
        # static inputs are made here, the output by the capture from the
        # shared pool, kept alive by the program
        static = tuple(x.detach().clone() for x in inputs)
        stream, pool = _side(device)
        out = []
        with _on_side(stream, device):
            g, inside = _capture(device, pool,
                                 lambda: out.append(fn(*static)),
                                 f"{self.what}: capturing a call")
            g.replay()
        _replayed.update(inside)
        self.graphs[key] = (g, static, out[0], inside)
        self.record(key)
        return _clone(out[0])


@dataclasses.dataclass
class ScanParts:
    """A scan (module doc, "Scans"): ``state`` (its tensors as attributes,
    with a ``rebind`` flag that the step honours: write in place, or bind
    the names to new tensors), ``step`` (no arguments), ``count``
    executions, ``result()`` the outputs (a tensor or a tuple) and
    ``restart()`` the in-place reset of the state from the inputs."""

    state: object
    step: object
    count: int
    result: object
    restart: object


def run_scan(scan: ScanParts, runner, key, *, last: bool = True):
    """Execute ``scan.step`` ``scan.count`` times: the first execution
    rebinding the state, then, where no state tensor requires grad or is
    wrapped by a ``torch.func`` transform (``sees_grad``), in place through
    ``runner`` at ``key`` (a replayed graph), else rebinding with no
    runner. ``runner`` None: every step inline. ``last``: as in
    ``LoopRunner.repeat`` (False when a later call replays the graph)."""
    S = scan.state
    S.rebind = True
    if runner is None:
        scan.step()
    else:
        runner.repeat(key, "step", scan.step, 1)        # its warm-up
    S.rebind = sees_grad(vars(S).values())
    if runner is None or S.rebind:
        for _ in range(scan.count - 1):
            scan.step()
    else:
        runner.repeat(key, "step", scan.step, scan.count - 1, last=last)


class Scan(Program):
    """A call that is a scan (module doc, "Scans"), with a ``Program``'s
    keys, grad rule and stale-storage record: per key the static inputs,
    the scan made from them and the ``LoopRunner`` that keeps its step's
    graph. ``close`` frees the graphs."""

    def close(self):
        for runner, *_ in self.graphs.values():
            runner.close()
        self.graphs.clear()

    def _drop(self, key):
        got = self.graphs.pop(key, None)
        if got is not None:
            got[0].close()
        self.touched.pop(key, None)
        self.records.pop(key, None)
        counts["recaptures"] += 1

    def __call__(self, key, make, inputs: tuple):
        """The scan ``make(*inputs)`` run to its end (module doc): the
        first call of a key its warm-up, later calls replays of its step
        after ``inputs`` are copied into the key's static inputs; the
        result of a replayed call is a fresh clone. A call that the grad
        rule must see runs eagerly."""
        device = inputs[0].device
        graphed = (device.type == "cuda" and not self.sharded
                   and not _eager_only[0] and key not in self.eager_keys)
        if graphed and key in self.touched and self.stale(key):
            self._drop(key)
        got = self.graphs.get(key) if graphed else None
        if got is not None and not _sees_grad_now(
                (*inputs, *(r() for r in self.touched[key]))):
            runner, static, scan = got
            with torch.no_grad():
                for st, x in zip(static, inputs):
                    st.copy_(x)
                scan.restart()
            runner.repeat(key, "step", scan.step, scan.count)
            return _clone(scan.result())
        if not graphed or key in self.touched or _sees_grad_now(inputs):
            scan = make(*inputs)
            _run_step(lambda: run_scan(scan, None, key))
            counts["eager_steps"] += 1
            return scan.result()
        # the key's warm-up: its scan made from static inputs, its step
        # captured by a runner that the key keeps
        with _Touched() as rec:
            static = tuple(x.detach().clone() for x in inputs)
            runner = LoopRunner(self.what, device)
            scan = make(*static)
            run_scan(scan, runner, key, last=False)
        self.touched[key] = rec.refs(skip=(*inputs, *static))
        self.record(key)
        if scan.state.rebind:               # autograd sees the call
            runner.close()
            self.eager_keys.add(key)
            return scan.result()
        self.graphs[key] = (runner, static, scan)
        return _clone(scan.result())
