from .engine import GrammarMatcher, GrammarSampler
from .gbnf import GBNFError, Grammar, parse_gbnf

__all__ = ["Grammar", "GrammarMatcher", "GrammarSampler", "GBNFError", "parse_gbnf"]
