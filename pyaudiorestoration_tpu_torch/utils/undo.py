"""Headless undo/redo command stack for marker editing sessions (counterpart
of pyaudiorestoration_tpu/utils/undo.py; the actions act on the port's own
markers, ``models/markers``).

Reference: util/undo.py — a QUndoStack with Add/Delete/Merge/Move/Delta
commands over marker lists.  Rebuilt without Qt: commands mutate a plain
marker list and the stack replays them; an optional callback mirrors the
reference's master-curve refresh (undo.py:25-34).
"""

from __future__ import annotations

__all__ = ["UndoStack", "AddAction", "DeleteAction", "MergeAction",
           "MoveAction", "DeltaAction"]


class _Action:
    def redo(self, markers):
        raise NotImplementedError

    def undo(self, markers):
        raise NotImplementedError


class AddAction(_Action):
    """Add markers (undo.py:48-55)."""

    def __init__(self, new_markers):
        self.markers = list(new_markers)

    def redo(self, markers):
        markers.extend(self.markers)

    def undo(self, markers):
        for m in self.markers:
            markers.remove(m)


class DeleteAction(_Action):
    """Remove markers (undo.py:58-64)."""

    def __init__(self, doomed):
        self.markers = list(doomed)

    def redo(self, markers):
        for m in self.markers:
            markers.remove(m)

    def undo(self, markers):
        markers.extend(self.markers)


class MergeAction(_Action):
    """Replace a group of markers with their merged line (undo.py:67-77)."""

    def __init__(self, new_markers, old_markers):
        self.new = list(new_markers)
        self.old = list(old_markers)

    def redo(self, markers):
        for m in self.old:
            markers.remove(m)
        markers.extend(self.new)

    def undo(self, markers):
        for m in self.new:
            markers.remove(m)
        markers.extend(self.old)


class MoveAction(_Action):
    """Offset trace lines vertically by b - a (undo.py:80-90)."""

    def __init__(self, targets, a, b):
        self.targets = list(targets)
        self.a = a
        self.b = b

    def _apply(self, markers, a, b):
        for m in self.targets:
            offset = b - a
            m.offset += offset
            m.speed = m.speed + offset
            m.speed_center[1] += offset

    def redo(self, markers):
        self._apply(markers, self.a, self.b)

    def undo(self, markers):
        self._apply(markers, self.b, self.a)


class DeltaAction(_Action):
    """Shift lag markers by per-marker deltas (undo.py:93-99)."""

    def __init__(self, targets, deltas):
        self.targets = list(targets)
        self.deltas = list(deltas)

    def redo(self, markers):
        for m, d in zip(self.targets, self.deltas):
            m.d += d

    def undo(self, markers):
        for m, d in zip(self.targets, self.deltas):
            m.d -= d


class UndoStack:
    """Replayable command stack over a marker list (undo.py:6-34)."""

    def __init__(self, markers=None, on_change=None):
        self.markers = markers if markers is not None else []
        self.on_change = on_change
        self._done = []
        self._undone = []
        self._clean_depth = 0

    def push(self, action):
        action.redo(self.markers)
        self._done.append(action)
        self._undone.clear()
        self._notify()

    def undo(self):
        if self._done:
            action = self._done.pop()
            action.undo(self.markers)
            self._undone.append(action)
            self._notify()

    def redo(self):
        if self._undone:
            action = self._undone.pop()
            action.redo(self.markers)
            self._done.append(action)
            self._notify()

    def set_clean(self):
        self._clean_depth = len(self._done)

    @property
    def is_clean(self):
        return len(self._done) == self._clean_depth

    def _notify(self):
        if self.on_change:
            self.on_change(self.markers)
