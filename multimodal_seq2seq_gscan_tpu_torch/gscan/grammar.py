"""Language layer: the gSCAN context-free grammar, redesigned around a
declarative production table.

Contract-pinned surfaces (they appear verbatim in ``dataset.txt`` /
``predict.json`` and are golden-tested; cf. reference
GroundedScan/grammar.py:179-285 for the serialization format and
grammar.py:333-601 for the command set):

- the derivation serialization ``"rules;lexicon"`` including rule-name
  spellings like ``"VP -> VV_intrans 'to' DP"`` and lexicon entries like
  ``"NT:JJ -> red:JJ -> big"`` / ``"T:to"``;
- the exact set AND order of generated commands per grammar type (dataset
  regeneration must be byte-stable);
- logical-form composition semantics, including the reference's positional
  quirk in ``VP -> VP RB`` (see ``_compose``);
- category-coherence filtering and the stacked-adjective de-duplication.

Everything else is original machinery: one ``Production`` record type plus a
single semantics interpreter replaces the reference's eight ``Rule``
subclasses, and a generator over sentential forms replaces its ``Template``
class and accumulate-into-a-list expansion.
"""

from collections import namedtuple
from itertools import product
from typing import ClassVar, Dict, Iterator, List, Optional, Tuple

import numpy as np

from multimodal_seq2seq_gscan_tpu_torch.gscan.types import (
    COLOR, ENTITY, EVENT, SIZE, LogicalForm, SemType, Term, Variable, Weights)

Nonterminal = namedtuple("Nonterminal", "name")
Terminal = namedtuple("Terminal", "name")

ROOT = Nonterminal("ROOT")
VP = Nonterminal("VP")
VV_intransitive = Nonterminal("VV_intransitive")
VV_transitive = Nonterminal("VV_transitive")
RB = Nonterminal("RB")
DP = Nonterminal("DP")
NP = Nonterminal("NP")
NN = Nonterminal("NN")
JJ = Nonterminal("JJ")

_VAR_COUNTER = [0]


def free_var(sem_type: SemType) -> Variable:
    name = "x{}".format(_VAR_COUNTER[0])
    _VAR_COUNTER[0] += 1
    return Variable(name, sem_type)


class Production:
    """One grammar production as plain data.

    ``combine`` names the semantics interpreted by :func:`_compose`:
    ``pass``/``verb``/``modify``/``conj`` for phrasal productions, ``lex``
    for word-level ones (which also carry ``word``/``sem_type``/``specs``).
    ``max_uses`` caps how many times the production may be applied within a
    single derivation (the reference's per-rule recursion bound).
    """

    __slots__ = ("name", "lhs", "rhs", "combine", "max_uses", "word",
                 "sem_type", "specs")

    def __init__(self, name: str, lhs: Nonterminal, rhs: Tuple,
                 combine: str, max_uses: int = 2, word: Optional[str] = None,
                 sem_type: Optional[SemType] = None,
                 specs: Optional[Weights] = None):
        self.name = name
        self.lhs = lhs
        self.rhs = rhs
        self.combine = combine
        self.max_uses = max_uses
        self.word = word
        self.sem_type = sem_type
        self.specs = specs

    @property
    def is_lexical(self) -> bool:
        return self.combine == "lex"

    def __repr__(self):
        return self.name


def _lexical(lhs: Nonterminal, word: str, sem_type: SemType,
             specs: Weights) -> Production:
    return Production(name="{} -> {}".format(lhs.name, word), lhs=lhs,
                      rhs=(Terminal(word),), combine="lex", max_uses=1,
                      word=word, sem_type=sem_type, specs=specs)


def _compose(production: Production, child_lfs: List[LogicalForm],
             meta: dict) -> LogicalForm:
    """Interpret a production's semantics over its children's logical forms.

    ``child_lfs`` is ordered by RHS position (terminals contribute nothing).
    """
    tag = production.combine
    if tag == "lex":
        var = free_var(production.sem_type)
        return LogicalForm(
            variables=(var,),
            terms=(Term(production.word, (var,), specs=production.specs,
                        meta=meta),))
    if tag == "pass":
        return child_lfs[0]
    if tag == "verb":
        # VP -> VV ('to') DP: patient role links event to entity; the DP's
        # logical form is surfaced through meta["arguments"] so the dataset
        # engine can extract the referent.
        vv, dp = child_lfs
        meta["arguments"].append(dp)
        return LogicalForm(
            variables=vv.variables + dp.variables,
            terms=vv.terms + dp.terms + (Term("patient",
                                              (vv.head, dp.head)),))
    if tag == "modify":
        # Both NP -> JJ NP and VP -> VP RB bind the FIRST child's logical
        # form onto the SECOND child's head variable, and keep the second
        # child's variables/terms first in the result. For VP -> VP RB this
        # means the verb phrase's meaning attaches to the *adverb's* event
        # variable: the reference's instantiate() receives its positional
        # arguments swapped relative to their parameter names
        # (grammar.py:109-112) and all downstream logical forms depend on
        # that dataflow, so it is preserved here.
        first, second = child_lfs
        bound = first.bind(second.head)
        assert bound.variables[0] == second.head
        return LogicalForm(variables=second.variables + bound.variables[1:],
                           terms=second.terms + bound.terms)
    if tag == "conj":
        left, right = child_lfs
        return LogicalForm(
            variables=left.variables + right.variables,
            terms=(left.terms + right.terms
                   + (Term("seq", (left.head, right.head)),)))
    raise ValueError("Unknown combine tag {!r}".format(tag))


class Derivation:
    """A constituency tree node: a production plus child nodes/terminals.

    Serializes to / parses from the exact ``dataset.txt`` "derivation"
    string format.
    """

    __slots__ = ("rule", "lhs", "children", "meta", "_lf")

    def __init__(self, rule: Production, children=None, meta=None):
        self.rule = rule
        self.lhs = rule.lhs
        self.children = children
        self.meta = meta if meta is not None else {}
        self._lf = None

    # -- construction ---------------------------------------------------

    @classmethod
    def from_rules(cls, rules: list, symbol=ROOT,
                   lexicon: Optional[dict] = None) -> "Derivation":
        """Rebuild the tree from phrasal rules in reverse application order
        (consumed by ``pop()``) plus per-category lexical assignments.

        This pop-from-the-end protocol is the wire contract: the rules
        string in dataset.txt lists phrasal productions bottom-up, and
        repeated lexical categories stack so the leftmost word pops first.
        """
        if isinstance(symbol, Terminal):
            return symbol
        if lexicon and symbol in lexicon:
            production = lexicon[symbol].pop()
        else:
            production = rules.pop()
        return cls(production,
                   children=tuple(cls.from_rules(rules, child, lexicon)
                                  for child in production.rhs))

    @classmethod
    def from_str(cls, rules_str: str, lexicon_str: str,
                 grammar: "Grammar") -> "Derivation":
        """Parse the ``"rules;lexicon"`` serialization (split by the caller).

        ``rules_str``: comma-joined phrasal production names, bottom-up.
        ``lexicon_str``: comma-joined entries — ``T:word`` for terminals,
        ``NT:<prod>[:<prod>...]`` for lexical productions, multiple
        productions per entry when a category occurs more than once.
        """
        phrasal = [grammar.rule_str_to_rules[name]
                   for name in rules_str.split(",")]
        lexicon: dict = {}
        for entry in lexicon_str.split(","):
            kind, _, body = entry.partition(":")
            for item in body.split(":"):
                if kind == "T":
                    lexicon[Terminal(item)] = [Terminal(item)]
                else:
                    production = grammar.rule_str_to_rules[item]
                    lexicon.setdefault(production.lhs, []).append(production)
        return cls.from_rules(phrasal, lexicon=lexicon)

    # -- views ------------------------------------------------------------

    def words(self) -> tuple:
        """The terminal yield, left to right (iterative traversal)."""
        out: List[str] = []
        stack = [self]
        while stack:
            node = stack.pop()
            if isinstance(node, Terminal):
                out.append(node.name)
            else:
                stack.extend(reversed(node.children))
        return tuple(out)

    def meaning(self, arguments: list) -> LogicalForm:
        """Compose the logical form bottom-up (memoized per node).

        Memoization semantics match the reference (grammar.py:234-245):
        only the FIRST call appends the verb arguments to ``arguments``;
        later calls return the cached LF without re-walking children.
        """
        self.meta["arguments"] = arguments
        if self._lf is None:
            child_lfs = [child.meaning(arguments) for child in self.children
                         if isinstance(child, Derivation)]
            self._lf = _compose(self.rule, child_lfs, self.meta)
        return self._lf

    # -- serialization ------------------------------------------------------

    def to_rules(self, phrasal: list, lexicon: dict) -> None:
        """Post-order walk filling the serialization structures.

        Phrasal productions list bottom-up; lexical productions stack
        front-first per category; terminals key the lexicon by Terminal."""
        for child in self.children:
            if isinstance(child, Derivation):
                child.to_rules(phrasal, lexicon)
            else:
                lexicon[child] = [child]
        if self.rule.is_lexical:
            lexicon[self.lhs] = [self.rule] + lexicon.get(self.lhs, [])
        else:
            phrasal.append(self.rule)

    def __repr__(self):
        phrasal: list = []
        lexicon: dict = {}
        self.to_rules(phrasal, lexicon)
        rules_str = ",".join(p.name for p in phrasal)
        entries = []
        for key, values in lexicon.items():
            if isinstance(key, Nonterminal):
                entries.append("NT" + "".join(
                    ":{}".format(v.name) for v in values))
            else:
                entries.append("T:{}".format(values[0].name))
        return rules_str + ";" + ",".join(entries)


# Phrasal production specs per grammar type. Order matters twice over: it is
# the template-expansion trial order AND (via rule_str_to_rules) the command
# enumeration order, both of which the generated dataset's example order
# depends on.
_PHRASAL_SPECS = {
    "ROOT -> VP": dict(lhs=ROOT, rhs=(VP,), combine="pass"),
    "ROOT -> VP 'and' ROOT": dict(lhs=ROOT, rhs=(VP, Terminal("and"), ROOT),
                                  combine="conj"),
    "VP -> VP RB": dict(lhs=VP, rhs=(VP, RB), combine="modify", max_uses=1),
    "VP -> VV_intrans 'to' DP": dict(
        lhs=VP, rhs=(VV_intransitive, Terminal("to"), DP), combine="verb"),
    "VP -> VV_trans DP": dict(lhs=VP, rhs=(VV_transitive, DP),
                              combine="verb"),
    "DP -> 'a' NP": dict(lhs=DP, rhs=(Terminal("a"), NP), combine="pass"),
    "NP -> JJ NP": dict(lhs=NP, rhs=(JJ, NP), combine="modify"),
    "NP -> NN": dict(lhs=NP, rhs=(NN,), combine="pass"),
}

_GRAMMAR_TYPES = {
    "conjunction": ["ROOT -> VP", "ROOT -> VP 'and' ROOT", "VP -> VP RB",
                    "VP -> VV_intrans 'to' DP", "VP -> VV_trans DP",
                    "DP -> 'a' NP", "NP -> JJ NP", "NP -> NN"],
    "adverb": ["ROOT -> VP", "VP -> VP RB", "VP -> VV_intrans 'to' DP",
               "VP -> VV_trans DP", "DP -> 'a' NP", "NP -> JJ NP",
               "NP -> NN"],
    "normal": ["ROOT -> VP", "VP -> VV_intrans 'to' DP", "VP -> VV_trans DP",
               "DP -> 'a' NP", "NP -> JJ NP", "NP -> NN"],
    "simple_trans": ["ROOT -> VP", "VP -> VV_trans DP", "DP -> 'a' NP",
                     "NP -> JJ NP", "NP -> NN"],
    "simple_intrans": ["ROOT -> VP", "VP -> VV_intrans 'to' DP",
                       "DP -> 'a' NP", "NP -> JJ NP", "NP -> NN"],
}

# The two simple grammars only allow ONE stacked adjective
# (reference grammar.py:340-341: NpWrapper(max_recursion=1)).
_NP_WRAP_USES = {"simple_trans": 1, "simple_intrans": 1}


class Grammar:
    """The gSCAN grammar: production table + enumeration + semantics."""

    def __init__(self, vocabulary: ClassVar, max_recursion: int = 1,
                 type_grammar: str = "normal",
                 np_rng: np.random.RandomState = None):
        """``np_rng`` draws :meth:`sample`'s productions (a fresh unseeded
        generator if None)."""
        assert type_grammar in _GRAMMAR_TYPES, (
            "Specified unsupported type grammar {}".format(type_grammar))
        self.type_grammar = type_grammar
        if type_grammar == "simple_intrans":
            assert len(vocabulary.get_intransitive_verbs()) > 0, (
                "Please specify intransitive verbs.")
        elif type_grammar == "simple_trans":
            assert len(vocabulary.get_transitive_verbs()) > 0, (
                "Please specify transitive verbs.")
        self.vocabulary = vocabulary
        self.max_recursion = max_recursion
        self._np_rng = (np_rng if np_rng is not None
                        else np.random.RandomState())

        self.rule_list = self._build_productions(type_grammar, vocabulary)
        self.rules: Dict[Nonterminal, List[Production]] = {}
        for production in self.rule_list:
            self.rules.setdefault(production.lhs, []).append(production)
        self.nonterminals = {nt.name: nt for nt in self.rules}
        self.terminals: dict = {}
        self.rule_str_to_rules = {p.name: p for p in self.rule_list}
        self.expandables = {p.lhs for p in self.rule_list if not p.is_lexical}

        self.categories = {
            "manner": set(vocabulary.get_adverbs()),
            "shape": set(vocabulary.get_nouns()),
            "color": set(vocabulary.get_color_adjectives()),
            "size": set(vocabulary.get_size_adjectives()),
        }
        self.word_to_category = {
            word: category for category, words in self.categories.items()
            for word in words}

        self.all_templates: list = []
        self.all_derivations: dict = {}
        self.command_statistics = self.empty_command_statistics()

    @staticmethod
    def _build_productions(type_grammar: str, vocabulary) -> List[Production]:
        """Phrasal productions for the grammar type, then the lexicon.

        Lexical order (verbs, adverbs, nouns, colors, sizes) fixes the
        command enumeration order."""
        assert (vocabulary.get_size_adjectives()
                or vocabulary.get_color_adjectives()), (
            "Please specify words for at least one of size_adjectives or "
            "color_adjectives.")
        productions = []
        np_wrap_uses = _NP_WRAP_USES.get(type_grammar, 2)
        for name in _GRAMMAR_TYPES[type_grammar]:
            spec = dict(_PHRASAL_SPECS[name])
            if name == "NP -> JJ NP":
                spec["max_uses"] = np_wrap_uses
            productions.append(Production(name=name, **spec))
        for verb in vocabulary.get_intransitive_verbs():
            productions.append(_lexical(
                VV_intransitive, verb, EVENT,
                Weights(action=verb, is_transitive=False)))
        for verb in vocabulary.get_transitive_verbs():
            productions.append(_lexical(
                VV_transitive, verb, EVENT,
                Weights(action=verb, is_transitive=True)))
        if type_grammar in ("adverb", "conjunction", "full"):
            for word in vocabulary.get_adverbs():
                productions.append(_lexical(RB, word, EVENT,
                                            Weights(manner=word)))
        for word in vocabulary.get_nouns():
            productions.append(_lexical(NN, word, ENTITY,
                                        Weights(noun=word)))
        for word in vocabulary.get_color_adjectives():
            productions.append(_lexical(JJ, word, ENTITY,
                                        Weights(adjective_type=COLOR)))
        for word in vocabulary.get_size_adjectives():
            productions.append(_lexical(JJ, word, ENTITY,
                                        Weights(adjective_type=SIZE)))
        return productions

    @staticmethod
    def empty_command_statistics():
        return {VV_intransitive: {}, VV_transitive: {}, NN: {}, JJ: {}, RB: {}}

    def reset_grammar(self):
        self.command_statistics = self.empty_command_statistics()
        self.all_templates.clear()
        self.all_derivations.clear()

    # -- template enumeration ------------------------------------------

    def _enumerate_templates(self) -> Iterator[Tuple[list, list]]:
        """All complete sentential forms, leftmost-first depth-first.

        Yields (symbols, productions-in-application-order); ``symbols``
        still contains lexical categories (NN/JJ/...), which the lexicon
        instantiates later. Per-production use counts bound recursion: a
        production may appear at most max(max_uses, 1) times per branch.
        """

        def expand(form, counts, applied):
            head_pos = next((i for i, s in enumerate(form)
                             if s in self.expandables), None)
            if head_pos is None:
                yield list(form), list(applied)
                return
            for production in self.rules[form[head_pos]]:
                if production.is_lexical:
                    continue
                used = counts.get(production.name, 0)
                if used >= max(production.max_uses, 1):
                    continue
                next_counts = dict(counts)
                next_counts[production.name] = used + 1
                next_form = (form[:head_pos] + list(production.rhs)
                             + form[head_pos + 1:])
                yield from expand(next_form, next_counts,
                                  applied + [production])

        return expand([ROOT], {}, [])

    # -- command instantiation -------------------------------------------

    def _split_on_category(self, words: List[str]):
        """Partition a word list into (same category as words[0], rest) —
        the stacked-adjective de-duplication: 'red big circle' is generated,
        'red red circle' never is."""
        anchor = self.category(words[0])
        same = [w for w in words if self.category(w) == anchor]
        other = [w for w in words[1:] if self.category(w) != anchor]
        return same, other

    def _instantiate_template(self, symbols: list,
                              rules_bottom_up: list) -> list:
        """Assign every compatible lexicon combination to a template.

        Adjacent repeats of one category get category-disjoint word slots;
        returns the resulting Derivations in ``itertools.product`` order.
        """
        slots: List[List[str]] = []
        word_entry: dict = {}
        previous = None
        for symbol in symbols:
            if isinstance(symbol, Nonterminal):
                options = self.rules.get(symbol)
                if not options:
                    # A category with no lexical entries (e.g. no transitive
                    # verbs configured): this template yields no commands.
                    return []
                for production in options:
                    word_entry[production.word] = production
                if previous == symbol:
                    same, other = self._split_on_category(slots.pop())
                    slots.append(same)
                    slots.append(other)
                else:
                    slots.append([p.word for p in options])
            else:
                word_entry[symbol.name] = symbol
                slots.append([symbol.name])
            previous = symbol

        derivations = []
        for command in product(*slots):
            assignment: dict = {}
            for word, symbol in zip(command, symbols):
                assignment[symbol] = [word_entry[word]] + assignment.get(
                    symbol, [])
                if isinstance(symbol, Nonterminal):
                    stats = self.command_statistics[symbol]
                    stats[word] = stats.get(word, 0) + 1
            derivation = Derivation.from_rules(
                list(rules_bottom_up), symbol=ROOT, lexicon=assignment)
            assert " ".join(derivation.words()) == " ".join(command), (
                "Derivation and command not the same.")
            derivations.append(derivation)
        return derivations

    def generate_all_commands(self) -> None:
        for symbols, applied in self._enumerate_templates():
            # from_rules consumes by pop(): store bottom-up (reversed
            # application order) — also the serialization order.
            self.all_templates.append((symbols, list(reversed(applied))))
        for i, (symbols, rules_bottom_up) in enumerate(self.all_templates):
            self.all_derivations[i] = self._instantiate_template(
                symbols, rules_bottom_up)

    # -- sampling & coherence ----------------------------------------------

    def sample(self, symbol=ROOT, last_rule=None, recursion=0):
        """Sample one random derivation (uniform over each symbol's
        productions; a production that would repeat at the recursion cap is
        excluded from the draw)."""
        if isinstance(symbol, Terminal):
            return symbol
        candidates = self.rules[symbol]
        if recursion == self.max_recursion - 1:
            candidates = [p for p in candidates if p is not last_rule]
        production = candidates[self._np_rng.randint(len(candidates))]
        next_recursion = recursion + 1 if production is last_rule else 0
        return Derivation(
            production,
            tuple(self.sample(child, production, next_recursion)
                  for child in production.rhs),
            meta={"recursion": recursion})

    def category(self, word: str) -> Optional[str]:
        return self.word_to_category.get(word)

    def is_coherent(self, logical_form) -> bool:
        """A LF is coherent iff no variable carries two modifiers of the
        same category (rejects e.g. 'the red blue circle')."""
        for variable in logical_form.variables:
            categories = [self.category(term.function)
                          for term in logical_form.terms
                          if variable in term.arguments]
            categories = [c for c in categories if c is not None]
            if len(categories) != len(set(categories)):
                return False
        return True

    def __str__(self):
        return "".join(p.name + ";" for p in self.rule_list)
