"""Alias-driven config factory.

This is the plugin/registry system of the framework: every configurable class
(scaling functions, filter banks, window functions, frame computers, pre- and
post-processors) derives from :class:`AliasedFactory` and declares a set of
string ``aliases``.  JSON/YAML configuration dicts of the form
``{"name": <alias>, **kwargs}`` then instantiate whole object hierarchies
recursively.

The JSON contract is identical to the reference implementation
(reference: src/pydrobert/speech/alias.py:28-100), including its conflict
resolution rule: when several subclasses claim the same alias, the most
recently registered one wins.  Unlike the reference, which re-walks
``__subclasses__()`` on every lookup, we resolve through a post-order
recursive search so user subclasses defined at any time remain discoverable
while keeping the same "last registered wins" semantics.
"""

import abc

from typing import Any, Mapping, Set, Type, TypeVar, Union

__all__ = [
    "AliasedFactory",
    "alias_factory_subclass_from_arg",
]

T = TypeVar("T", bound="AliasedFactory", covariant=True)


class AliasedFactory(abc.ABC):
    """ABC whose concrete subclasses can be instantiated by a string alias."""

    aliases: Set[str] = set()
    """Class aliases recognised by :func:`from_alias`."""

    @classmethod
    def _resolve_alias(cls, alias: str):
        # post-order, last-registered-child-first traversal: descendants are
        # preferred over ancestors, and later registrations shadow earlier
        # ones. Matches the reference's DFS-with-revisit resolution order
        # (reference: alias.py:58-69).
        for child in reversed(cls.__subclasses__()):
            found = child._resolve_alias(alias)
            if found is not None:
                return found
        return cls if alias in cls.aliases else None

    @classmethod
    def from_alias(cls: Type[T], alias: str, *args, **kwargs) -> T:
        """Instantiate whichever subclass of ``cls`` goes by ``alias``.

        Searches ``cls`` and all its (transitively) registered subclasses.
        Conflicts resolve to the most recently registered match.

        Raises
        ------
        ValueError
            If no subclass claims the alias.
        """
        subclass = cls._resolve_alias(alias)
        if subclass is None:
            raise ValueError(f"Cannot find subclass with alias '{alias}'")
        return subclass(*args, **kwargs)


def alias_factory_subclass_from_arg(
    factory_class: Type[T], arg: Union[T, str, Mapping[str, Any]]
) -> T:
    """Coerce ``arg`` into an instance of ``factory_class``.

    The coercion strategy is deliberately limited so it composes with plain
    JSON config files (reference: alias.py:72-100):

    1. an instance of ``factory_class`` passes through unchanged;
    2. a string is treated as an alias with no constructor arguments;
    3. a mapping has its ``"alias"`` key (falling back to ``"name"``)
       popped as the alias; the remaining items are keyword arguments.
    """
    if isinstance(arg, factory_class):
        return arg
    if isinstance(arg, str):
        return factory_class.from_alias(arg)
    arg = dict(arg)
    if "alias" in arg:
        alias = arg.pop("alias")
    else:
        alias = arg.pop("name")
    return factory_class.from_alias(alias, **arg)
