"""Configurations and traffic mixes whose keys note when they are read.

A cell's files hold only what the harness reads: a driver reads every key
of its configuration and mix when it is built, and ``refuse_unread``
refuses the cell if any key was never read, so a key that would change
nothing (a mislabelled cell) stops the run before it measures.
"""
from __future__ import annotations


class Keys(dict):
    """A dict (and its nested dicts) that records which keys were read."""

    def __init__(self, data):
        super().__init__((k, Keys(v) if isinstance(v, dict) else v)
                         for k, v in dict.items(data))
        self.read, self.skipped = set(), set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)

    def skip(self, *keys):
        """Mark ``keys`` (and what they hold) as another reader's."""
        self.skipped.update(keys)

    def unread(self, prefix=""):
        """The dotted names of the keys nothing read."""
        out = []
        for k, v in dict.items(self):
            if k in self.skipped:
                continue
            if k not in self.read:
                out.append(prefix + k)
            elif isinstance(v, Keys):
                out += v.unread(prefix + k + ".")
        return out


def refuse_unread(**parts):
    """Raise naming every key of ``parts`` (name -> ``Keys``) that was not
    read."""
    unread = [f"{name} key {k!r}" for name, keys in parts.items()
              for k in keys.unread()]
    if unread:
        raise ValueError("nothing reads " + ", ".join(unread)
                         + ": the harness would not run what the files say")
