"""Scope: hierarchical name -> runtime value map.

Reference parity: paddle/fluid/framework/scope.h:39-81 (Var / FindVar;
child scopes via `parent`). Values are torch tensors on the Executor's device.
Parameters and optimizer state persist here between Executor.run calls,
so a training loop never copies them back to the host.
"""

import contextlib
import threading


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent

    def var(self, name):
        """Find-or-create in THIS scope (reference Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def find_var(self, name):
        """Recursive lookup (reference Scope::FindVar). Returns value or None."""
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def set_var(self, name, value):
        self._vars[name] = value

    def erase(self, name):
        """Drop `name` from THIS scope (the delete_var op)."""
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars.keys())


_global_scope = Scope()
_tls = threading.local()


def _stack():
    """Per-THREAD scope stack; a fresh thread starts at the process-wide
    global scope, so one thread's scope_guard never redirects another's."""
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = [_global_scope]
    return st


def global_scope():
    return _stack()[-1]


def reset_global_scope(scope=None):
    """Replace the process-wide global scope (test isolation)."""
    global _global_scope
    _global_scope = scope if scope is not None else Scope()
    _tls.stack = [_global_scope]
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    st = _stack()
    st.append(scope)
    try:
        yield
    finally:
        st.pop()
