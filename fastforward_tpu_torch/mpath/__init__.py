"""mpath — module-tree query language (`fastforward_tpu/mpath/`).

Queries address modules in a `torch.nn.Module` tree by path, its segments
the parts of ``named_modules()`` names:

    ``**``                     any number of segments (including zero)
    ``*``                      exactly one segment (any name)
    ``name``                   a literal attribute name / list index
    ``[cls:SomeClass]``        module is an instance of SomeClass
    ``[re:pattern]``           segment name matches the regex
    ``[quantizer:tag/path]``   module is a quantizer whose metadata carries
                               the tag
    ``~fragment``              negation of a fragment
    ``a/b/c``                  path joining

Selectors compose in Python with ``/`` (join), ``&``, ``|`` and ``~``.
`search` walks the module tree and returns an `MPathCollection` supporting
set operations and batch updates.
"""

from fastforward_tpu_torch.mpath.fragments import (
    ClassFragment,
    Fragment,
    NameFragment,
    QuantizerTagFragment,
    RegexFragment,
    WildcardFragment,
)
from fastforward_tpu_torch.mpath.parser import mpath_query_extension, parse
from fastforward_tpu_torch.mpath.search import MPathCollection, MPathItem, search
from fastforward_tpu_torch.mpath.selector import BaseSelector, MultiSelector, Selector

__all__ = [
    "query",
    "search",
    "parse",
    "mpath_query_extension",
    "Fragment",
    "NameFragment",
    "WildcardFragment",
    "ClassFragment",
    "RegexFragment",
    "QuantizerTagFragment",
    "Selector",
    "MultiSelector",
    "BaseSelector",
    "MPathCollection",
    "MPathItem",
]


def query(query_str, context=None):
    """Parse a query string into a Selector.

    ``context`` maps names used in ``[cls:...]`` fragments to classes;
    the classes of `torch.nn` and of the port's `nn`, and the NNX names of
    `parser.NNX_ALIASES`, resolve without it.
    """
    if isinstance(query_str, BaseSelector):
        return query_str
    return parse(query_str, context=context)
