"""JS tokenizer for the frontend subset (see package docstring).

Tokens: (type, value, line). Types: num, str, template, regex, ident,
keyword, punct, eof. Template tokens carry the decomposed parts:
``("template", [("str", s) | ("expr", token_list), ...], line)`` — the
parser re-parses each expr token list.
"""

from __future__ import annotations

KEYWORDS = {
    "var", "let", "const", "function", "return", "if", "else", "for", "while",
    "do", "break", "continue", "new", "delete", "typeof", "instanceof", "in",
    "of", "try", "catch", "finally", "throw", "null", "undefined", "true",
    "false", "this", "async", "await", "void", "get", "set", "switch", "case",
    "default",
}

# Longest first so '===' wins over '=='.
PUNCT = sorted(
    [
        "===", "!==", "**=", "...", "=>", "==", "!=", "<=", ">=", "&&", "||",
        "??", "?.", "**",
        "++", "--", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<", ">>",
        "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/",
        "%", "&", "|", "^", "!", "~", "?", ":", "=", ".",
    ],
    key=len,
    reverse=True,
)

ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "v": "\v",
           "0": "\0", "'": "'", '"': '"', "`": "`", "\\": "\\", "/": "/",
           "\n": ""}


class LexError(SyntaxError):
    pass


def _ident_start(c: str) -> bool:
    return c.isalpha() or c in "_$"


def _ident_part(c: str) -> bool:
    return c.isalnum() or c in "_$"


class Lexer:
    def __init__(self, src: str, filename: str = "<js>"):
        self.src = src
        self.filename = filename
        self.pos = 0
        self.line = 1
        self.tokens: list[tuple] = []

    def error(self, msg: str) -> LexError:
        return LexError(f"{self.filename}:{self.line}: {msg}")

    def tokenize(self) -> list[tuple]:
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c == "\n":
                self.line += 1
                self.pos += 1
            elif c.isspace():
                self.pos += 1
            elif self.src.startswith("//", self.pos):
                nl = self.src.find("\n", self.pos)
                self.pos = len(self.src) if nl < 0 else nl
            elif self.src.startswith("/*", self.pos):
                end = self.src.find("*/", self.pos + 2)
                if end < 0:
                    raise self.error("unterminated block comment")
                self.line += self.src.count("\n", self.pos, end)
                self.pos = end + 2
            elif c in "'\"":
                self.tokens.append(self._string(c))
            elif c == "`":
                self.tokens.append(self._template())
            elif c.isdigit() or (c == "." and self.pos + 1 < len(self.src)
                                 and self.src[self.pos + 1].isdigit()):
                self.tokens.append(self._number())
            elif _ident_start(c):
                self.tokens.append(self._ident())
            elif c == "/" and self._regex_allowed():
                self.tokens.append(self._regex())
            else:
                self.tokens.append(self._punct())
        self.tokens.append(("eof", None, self.line))
        return self.tokens

    # ---- helpers ---------------------------------------------------------------

    def _regex_allowed(self) -> bool:
        """A ``/`` begins a regex when it can't be division: after nothing,
        an operator, ``(``/``[``/``,``/``{``/``;``/``:``, or keywords like
        ``return``/``typeof``. After idents/literals/closing brackets it is
        division."""
        for typ, val, _ in reversed(self.tokens):
            if typ in ("num", "str", "template", "regex"):
                return False
            if typ == "ident":
                return False
            if typ == "keyword":
                return val not in ("this", "null", "undefined", "true", "false")
            if typ == "punct":
                return val not in (")", "]", "}", "++", "--")
            return True
        return True

    def _string(self, quote: str) -> tuple:
        line = self.line
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.src):
                raise self.error("unterminated string")
            c = self.src[self.pos]
            if c == quote:
                self.pos += 1
                return ("str", "".join(out), line)
            if c == "\n":
                raise self.error("newline in string")
            if c == "\\":
                self.pos += 1
                e = self.src[self.pos]
                if e == "u":
                    if self.src[self.pos + 1] == "{":
                        end = self.src.index("}", self.pos)
                        out.append(chr(int(self.src[self.pos + 2:end], 16)))
                        self.pos = end + 1
                    else:
                        out.append(chr(int(self.src[self.pos + 1:self.pos + 5], 16)))
                        self.pos += 5
                    continue
                if e == "x":
                    out.append(chr(int(self.src[self.pos + 1:self.pos + 3], 16)))
                    self.pos += 3
                    continue
                out.append(ESCAPES.get(e, e))
                self.pos += 1
                if e == "\n":
                    self.line += 1
                continue
            out.append(c)
            self.pos += 1

    def _template(self) -> tuple:
        line = self.line
        self.pos += 1  # opening backtick
        parts: list[tuple] = []
        buf: list[str] = []
        while True:
            if self.pos >= len(self.src):
                raise self.error("unterminated template literal")
            c = self.src[self.pos]
            if c == "`":
                self.pos += 1
                if buf:
                    parts.append(("str", "".join(buf)))
                return ("template", parts, line)
            if c == "\\":
                e = self.src[self.pos + 1]
                buf.append(ESCAPES.get(e, e))
                self.pos += 2
                continue
            if c == "$" and self.src.startswith("${", self.pos):
                if buf:
                    parts.append(("str", "".join(buf)))
                    buf = []
                # Find the matching } (nesting-aware; strings inside too).
                depth = 1
                j = self.pos + 2
                start = j
                while depth:
                    if j >= len(self.src):
                        raise self.error("unterminated ${} in template")
                    cj = self.src[j]
                    if cj in "'\"`":
                        quote = cj
                        j += 1
                        while self.src[j] != quote:
                            if self.src[j] == "\\":
                                j += 1
                            j += 1
                    elif cj == "{":
                        depth += 1
                    elif cj == "}":
                        depth -= 1
                        if not depth:
                            break
                    j += 1
                inner = Lexer(self.src[start:j], self.filename).tokenize()
                parts.append(("expr", inner))
                self.pos = j + 1
                continue
            if c == "\n":
                self.line += 1
            buf.append(c)
            self.pos += 1

    def _number(self) -> tuple:
        line = self.line
        start = self.pos
        src = self.src
        if src.startswith(("0x", "0X"), self.pos):
            self.pos += 2
            while self.pos < len(src) and src[self.pos] in "0123456789abcdefABCDEF":
                self.pos += 1
            return ("num", float(int(src[start:self.pos], 16)), line)
        while self.pos < len(src) and (src[self.pos].isdigit() or src[self.pos] == "."):
            self.pos += 1
        if self.pos < len(src) and src[self.pos] in "eE":
            self.pos += 1
            if src[self.pos] in "+-":
                self.pos += 1
            while self.pos < len(src) and src[self.pos].isdigit():
                self.pos += 1
        return ("num", float(src[start:self.pos]), line)

    def _ident(self) -> tuple:
        line = self.line
        start = self.pos
        while self.pos < len(self.src) and _ident_part(self.src[self.pos]):
            self.pos += 1
        word = self.src[start:self.pos]
        return ("keyword" if word in KEYWORDS else "ident", word, line)

    def _regex(self) -> tuple:
        line = self.line
        start = self.pos
        self.pos += 1  # opening /
        in_class = False
        while True:
            if self.pos >= len(self.src):
                raise self.error("unterminated regex literal")
            c = self.src[self.pos]
            if c == "\\":
                self.pos += 2
                continue
            if c == "[":
                in_class = True
            elif c == "]":
                in_class = False
            elif c == "/" and not in_class:
                break
            elif c == "\n":
                raise self.error("newline in regex literal")
            self.pos += 1
        body = self.src[start + 1:self.pos]
        self.pos += 1
        fstart = self.pos
        while self.pos < len(self.src) and self.src[self.pos].isalpha():
            self.pos += 1
        flags = self.src[fstart:self.pos]
        return ("regex", (body, flags), line)

    def _punct(self) -> tuple:
        for p in PUNCT:
            if self.src.startswith(p, self.pos):
                self.pos += len(p)
                return ("punct", p, self.line)
        raise self.error(f"unexpected character {self.src[self.pos]!r}")


def tokenize(src: str, filename: str = "<js>") -> list[tuple]:
    return Lexer(src, filename).tokenize()
