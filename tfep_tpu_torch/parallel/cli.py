"""Declarative command-line wrappers for file-based engines.

A copy of ``tfep_tpu/parallel/cli.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

External engines driven through their CLI (GROMACS ``gmx``, CPMD, PLUMED)
are wrapped as :class:`CLITool` subclasses: each command-line option is
declared once as a class attribute, and an instance renders itself to a
``subprocess``-ready argv with :meth:`CLITool.to_subprocess`. Capability
parity with the reference's CLI wrapper layer
(upstream tfep/utils/cli/tool.py), rebuilt around a two-stage
option protocol:

* ``coerce(value)`` runs at assignment time (validation, path
  normalization) and the result is stored in a per-instance value dict;
* ``render(value)`` runs at argv-build time and yields the argv tokens.

Example
-------
>>> class Sort(CLITool):
...     EXECUTABLE_PATH = 'sort'
...     key = KeyValueOption('-k')
...     numeric = FlagOption('-n')
>>> Sort(numeric=True).to_subprocess()
['sort', '-n']
>>> Sort('data.txt', key=2).to_subprocess()
['sort', '-k', '2', 'data.txt']
"""

from __future__ import annotations

import os

__all__ = ['CLITool', 'CLIOption', 'KeyValueOption', 'AbsolutePathOption',
           'FlagOption']


class CLIOption:
    """One declared command-line option of a :class:`CLITool`.

    Subclasses customize two hooks:

    * :meth:`coerce` — transform/validate the value when it is assigned
      (default: pass through unchanged);
    * :meth:`render` — turn the stored value into argv tokens (an
      unassigned / ``None`` value renders to nothing).
    """

    def __init__(self, flag: str):
        self.flag = flag          # the literal command-line token
        self.attr = None          # attribute name, filled by __set_name__

    def __set_name__(self, owner, name):
        self.attr = name

    # -- descriptor protocol backed by the instance's value dict -------- #
    def __get__(self, tool, owner=None):
        if tool is None:
            return self
        return tool.option_values.get(self.attr)

    def __set__(self, tool, value):
        tool.option_values[self.attr] = self.coerce(value)

    # -- customization hooks -------------------------------------------- #
    def coerce(self, value):
        """Validate/transform ``value`` at assignment time."""
        return value

    def render(self, value):
        """Yield the argv tokens for a stored (non-``None``) value."""
        raise NotImplementedError


class KeyValueOption(CLIOption):
    """An option rendered as ``<name> <value>`` (value stringified)."""

    def render(self, value):
        yield self.flag
        yield str(value)


class AbsolutePathOption(KeyValueOption):
    """A path option pinned to an absolute path when assigned.

    Engine tasks routinely ``chdir`` into per-sample scratch directories;
    resolving at assignment keeps the option pointing at the same file
    regardless of the working directory at launch time.
    """

    def coerce(self, value):
        return os.path.abspath(value)


class FlagOption(CLIOption):
    """A valueless boolean switch.

    ``True`` renders the flag itself, ``None`` renders nothing. For
    ``False``, nothing is rendered unless ``prepend_to_false`` is given,
    in which case that string (typically ``'no'``) is spliced in right
    after the leading dashes (GROMACS-style ``-fp`` / ``-nofp`` pairs).
    """

    def __init__(self, flag: str, prepend_to_false: str = None):
        super().__init__(flag)
        self.prepend_to_false = prepend_to_false

    def coerce(self, value):
        if value is not None and not isinstance(value, bool):
            raise ValueError(
                f'{self.attr} must be either a boolean or None')
        return value

    def render(self, value):
        if value:
            yield self.flag
        elif self.prepend_to_false is not None:
            dashes = len(self.flag) - len(self.flag.lstrip('-'))
            yield (self.flag[:dashes] + self.prepend_to_false
                   + self.flag[dashes:])


class CLITool:
    """Base class for declarative CLI wrappers.

    Class-level configuration: ``EXECUTABLE_PATH`` names the binary (an
    instance may override it via the ``executable_path`` keyword) and
    ``SUBPROGRAM`` optionally names a subcommand inserted right after it
    (e.g. ``gmx mdrun``). Declared options render in declaration order
    (base classes first); positional constructor arguments are appended
    verbatim at the end of the argv.
    """

    EXECUTABLE_PATH = None
    SUBPROGRAM = None

    # Maps public option name -> CLIOption spec, accumulated across the
    # class hierarchy and ordered alphabetically by attribute name — the
    # reference renders options through inspect.getmembers, which sorts
    # (tool.py:157-163), so identical tool definitions produce identical
    # argv on both frameworks (tests/parity/test_cli_plumed_parity.py).
    _cli_options: dict = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        registry = {}
        for klass in reversed(cls.__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, CLIOption):
                    registry[name] = attr
        cls._cli_options = dict(sorted(registry.items()))

    def __init__(self, *args, executable_path=None, **kwargs):
        self.args = args
        self.option_values = {}
        self._executable_path = executable_path
        for name, value in kwargs.items():
            if name not in self._cli_options:
                raise AttributeError(f'Undefined CLI option {name}')
            setattr(self, name, value)

    @property
    def executable_path(self):
        """Executable to launch: the per-instance override if given, else
        the class ``EXECUTABLE_PATH``."""
        if self._executable_path is not None:
            return self._executable_path
        return self.EXECUTABLE_PATH

    @executable_path.setter
    def executable_path(self, value):
        self._executable_path = value

    def to_subprocess(self):
        """Render the full argv list for the ``subprocess`` module."""
        argv = [self.executable_path]
        if self.SUBPROGRAM is not None:
            argv.append(self.SUBPROGRAM)
        for name, spec in self._cli_options.items():
            value = self.option_values.get(name)
            if value is not None:
                argv.extend(spec.render(value))
        argv += [str(arg) for arg in self.args]
        return argv
