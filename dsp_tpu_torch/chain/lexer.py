"""Effects-chain lexer (reference: effects_chain.c:36-230).

Splits on whitespace with double-quote quoting, backslash escapes, ``#``
comments (word-initial, to end of line), escaped/quoted newlines as line
continuations, and line/column tracking for caret diagnostics.

Token kinds: literal, escaped-literal (word-initial backslash: never treated
as a keyword/structural token), ``:selector``, ``{``, ``}``, ``@file``, ``!``.
Quoting removes quote characters but does NOT protect structural tokens
(matching the reference, where only a leading backslash does).
"""

from dataclasses import dataclass

TOK_LITERAL = 0
TOK_ESC_LITERAL = 1
TOK_CH_SEL = 2
TOK_BLOCK_START = 3
TOK_BLOCK_END = 4
TOK_SOURCE = 5
TOK_ALLOW_FAIL = 6


@dataclass
class Token:
    id: int
    str: str
    line: int
    col: int
    len: int


def token_id(s):
    if s.startswith(":"):
        return TOK_CH_SEL
    if s == "{":
        return TOK_BLOCK_START
    if s == "}":
        return TOK_BLOCK_END
    if s.startswith("@") and len(s) > 1:
        return TOK_SOURCE
    if s == "!":
        return TOK_ALLOW_FAIL
    return TOK_LITERAL


def is_keyword_token(tok, effect_lookup):
    """A token ends an argument list if it is structural or a known effect
    name (effects_chain.c:232-241)."""
    if tok.id == TOK_ESC_LITERAL:
        return False
    if tok.id != TOK_LITERAL:
        return True
    return effect_lookup(tok.str) is not None


def _make_token(word, line, col, length):
    if word.startswith("\\"):
        return Token(TOK_ESC_LITERAL, word[1:], line, col, length)
    tid = token_id(word)
    s = word
    if tid in (TOK_CH_SEL, TOK_SOURCE):
        s = word[1:]
    elif tid in (TOK_BLOCK_START, TOK_BLOCK_END, TOK_ALLOW_FAIL):
        s = ""
    return Token(tid, s, line, col, length)


class LexError(ValueError):
    def __init__(self, msg, line, col):
        super().__init__(msg)
        self.line = line
        self.col = col


def lex_string(s):
    """Tokenize a chain string. Returns (tokens, line_strs)."""
    tokens = []
    line_strs = s.split("\n")
    line = 0
    col_base = 0
    cont = 0
    buf = []
    start = None
    raw_start = None
    esc = False
    quo = False
    i = 0
    n = len(s)
    while True:
        c = s[i] if i < n else None
        if c == "\\" and not esc:
            esc = True
            if start is None:
                # word-initial backslash is kept: marks an escaped literal
                start = (line, i - col_base)
                raw_start = i
                buf.append(c)
        elif c == '"' and not esc:
            if start is None:
                start = (line, i - col_base)
                raw_start = i
            quo = not quo
        elif c == "#" and not esc and not quo and start is None:
            while i < n and s[i] != "\n":
                i += 1
            continue
        elif c is None or (not esc and not quo and c.isspace()):
            if c is None and quo:
                raise LexError(
                    "unterminated quoted string", line, (raw_start if raw_start is not None else i) - col_base
                )
            if start is not None:
                tokens.append(_make_token("".join(buf), start[0], start[1], i - raw_start))
                buf = []
                start = None
                raw_start = None
            if c is None:
                break
            if c == "\n":
                line += cont + 1
                col_base = i + 1
                cont = 0
            esc = False
        else:
            if start is None:
                start = (line, i - col_base)
                raw_start = i
            buf.append(c)
            if c == "\n":
                cont += 1  # continuation inside quotes/escape
            esc = False
        i += 1
    return tokens, line_strs
