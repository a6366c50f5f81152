"""Recursive-descent parser for the frontend JS subset → tuple AST.

Anything outside the subset fails loudly at parse time — a frontend change
that starts using an unsupported construct breaks CI instead of silently
skipping execution.
"""

from __future__ import annotations

from kubeflow_tpu_torch.testing.jsrt.lexer import tokenize

ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "**="}

# Binary precedence (higher binds tighter). ?? sits at the ||/&& tier
# (the spec forbids unparenthesized mixing; we accept it, || first).
BINARY = {
    "??": 1, "||": 1, "&&": 2,
    "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6, "===": 6, "!==": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7, "instanceof": 7, "in": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
    "**": 11,  # right-associative (handled in binary())
}


class ParseError(SyntaxError):
    pass


class Parser:
    def __init__(self, tokens: list[tuple], filename: str = "<js>"):
        self.toks = tokens
        self.i = 0
        self.filename = filename

    # ---- token plumbing --------------------------------------------------------

    def peek(self, offset: int = 0) -> tuple:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self) -> tuple:
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def at(self, typ: str, val=None, offset: int = 0) -> bool:
        t, v, _ = self.peek(offset)
        return t == typ and (val is None or v == val)

    def eat(self, typ: str, val=None) -> bool:
        if self.at(typ, val):
            self.i += 1
            return True
        return False

    def expect(self, typ: str, val=None) -> tuple:
        if not self.at(typ, val):
            t, v, line = self.peek()
            raise ParseError(
                f"{self.filename}:{line}: expected {val or typ}, got {v!r}")
        return self.next()

    def error(self, msg: str) -> ParseError:
        _, v, line = self.peek()
        return ParseError(f"{self.filename}:{line}: {msg} (at {v!r})")

    # ---- program ---------------------------------------------------------------

    def parse_program(self) -> list:
        stmts = []
        while not self.at("eof"):
            stmts.append(self.statement())
        return stmts

    # ---- statements ------------------------------------------------------------

    def statement(self):
        if self.eat("punct", ";"):
            return ("empty",)
        if self.at("punct", "{"):
            return self.block()
        if self.at("keyword", "var") or self.at("keyword", "let") or \
                self.at("keyword", "const"):
            stmt = self.var_decl()
            self.semi()
            return stmt
        if self.at("keyword", "async") and self.at("keyword", "function", 1):
            self.next()
            return self.func_decl(is_async=True)
        if self.at("keyword", "function"):
            return self.func_decl(is_async=False)
        if self.eat("keyword", "return"):
            if self.at("punct", ";") or self.at("punct", "}") or self.at("eof"):
                expr = None
            else:
                expr = self.expression()
            self.semi()
            return ("return", expr)
        if self.eat("keyword", "if"):
            self.expect("punct", "(")
            cond = self.expression()
            self.expect("punct", ")")
            then = self.statement()
            other = self.statement() if self.eat("keyword", "else") else None
            return ("if", cond, then, other)
        if self.at("keyword", "for"):
            return self.for_stmt()
        if self.eat("keyword", "while"):
            self.expect("punct", "(")
            cond = self.expression()
            self.expect("punct", ")")
            return ("while", cond, self.statement())
        if self.eat("keyword", "do"):
            body = self.statement()
            self.expect("keyword", "while")
            self.expect("punct", "(")
            cond = self.expression()
            self.expect("punct", ")")
            self.semi()
            return ("dowhile", body, cond)
        if self.eat("keyword", "try"):
            block = self.block()
            param = catch_block = final = None
            if self.eat("keyword", "catch"):
                if self.eat("punct", "("):
                    param = self.pattern()
                    self.expect("punct", ")")
                catch_block = self.block()
            if self.eat("keyword", "finally"):
                final = self.block()
            return ("try", block, param, catch_block, final)
        if self.eat("keyword", "throw"):
            expr = self.expression()
            self.semi()
            return ("throw", expr)
        if self.eat("keyword", "break"):
            self.semi()
            return ("break",)
        if self.eat("keyword", "continue"):
            self.semi()
            return ("continue",)
        if self.eat("keyword", "switch"):
            self.expect("punct", "(")
            disc = self.expression()
            self.expect("punct", ")")
            self.expect("punct", "{")
            cases = []
            while not self.eat("punct", "}"):
                if self.eat("keyword", "case"):
                    test = self.expression()
                else:
                    self.expect("keyword", "default")
                    test = None
                self.expect("punct", ":")
                body = []
                while not (self.at("keyword", "case") or
                           self.at("keyword", "default") or
                           self.at("punct", "}")):
                    body.append(self.statement())
                cases.append((test, body))
            return ("switch", disc, cases)
        expr = self.expression()
        self.semi()
        return ("expr_stmt", expr)

    def semi(self) -> None:
        """Semicolons required except before '}' / EOF (the shipped JS is
        prettier-formatted; full ASI is out of subset)."""
        if self.eat("punct", ";"):
            return
        if self.at("punct", "}") or self.at("eof"):
            return
        raise self.error("missing semicolon")

    def block(self):
        self.expect("punct", "{")
        stmts = []
        while not self.eat("punct", "}"):
            stmts.append(self.statement())
        return ("block", stmts)

    def var_decl(self):
        kind = self.next()[1]
        decls = []
        while True:
            pat = self.pattern()
            init = self.assignment() if self.eat("punct", "=") else None
            decls.append((pat, init))
            if not self.eat("punct", ","):
                break
        return ("var", kind, decls)

    def func_decl(self, is_async: bool):
        self.expect("keyword", "function")
        name = self.ident_name()
        params, rest = self.param_list()
        body = self.block()
        return ("func_decl", name, params, rest, body, is_async)

    def for_stmt(self):
        self.expect("keyword", "for")
        self.expect("punct", "(")
        # for (const x of y) / for (const [k, v] of y) / for (x in y)
        if self.at("keyword", "var") or self.at("keyword", "let") or \
                self.at("keyword", "const"):
            kind = self.next()[1]
            pat = self.pattern()
            if self.eat("keyword", "of"):
                it = self.assignment()
                self.expect("punct", ")")
                return ("forof", kind, pat, it, self.statement())
            if self.eat("keyword", "in"):
                obj = self.assignment()
                self.expect("punct", ")")
                return ("forin", kind, pat, obj, self.statement())
            init = self.assignment() if self.eat("punct", "=") else None
            decls = [(pat, init)]
            while self.eat("punct", ","):
                p2 = self.pattern()
                i2 = self.assignment() if self.eat("punct", "=") else None
                decls.append((p2, i2))
            init_node = ("var", kind, decls)
        elif self.at("punct", ";"):
            init_node = None
        else:
            init_node = ("expr_stmt", self.expression())
        self.expect("punct", ";")
        cond = None if self.at("punct", ";") else self.expression()
        self.expect("punct", ";")
        update = None if self.at("punct", ")") else self.expression()
        self.expect("punct", ")")
        return ("for", init_node, cond, update, self.statement())

    # ---- patterns (destructuring) ----------------------------------------------

    def ident_name(self) -> str:
        t, v, line = self.peek()
        # Contextual keywords usable as identifiers/property names.
        if t == "ident" or (t == "keyword" and v in (
                "get", "set", "of", "async", "undefined")):
            self.next()
            return v
        raise self.error("expected identifier")

    def pattern(self):
        if self.at("punct", "["):
            return self.array_pattern()
        if self.at("punct", "{"):
            return self.object_pattern()
        return ("pid", self.ident_name())

    def array_pattern(self):
        self.expect("punct", "[")
        elems: list = []
        rest = None
        while not self.at("punct", "]"):
            if self.eat("punct", ","):
                elems.append(None)  # hole: [, v]
                continue
            if self.eat("punct", "..."):
                rest = self.pattern()
                break
            pat = self.pattern()
            default = self.assignment() if self.eat("punct", "=") else None
            elems.append((pat, default))
            if not self.at("punct", "]"):
                self.expect("punct", ",")
        self.expect("punct", "]")
        return ("parr", elems, rest)

    def object_pattern(self):
        self.expect("punct", "{")
        props: list = []
        rest = None
        while not self.at("punct", "}"):
            if self.eat("punct", "..."):
                rest = self.pattern()
                break
            key = self.prop_name()
            if self.eat("punct", ":"):
                target = self.pattern()
            else:
                target = ("pid", key)
            default = self.assignment() if self.eat("punct", "=") else None
            props.append((key, target, default))
            if not self.at("punct", "}"):
                self.expect("punct", ",")
        self.expect("punct", "}")
        return ("pobj", props, rest)

    def prop_name(self) -> str:
        t, v, _ = self.peek()
        if t == "str":
            self.next()
            return v
        if t == "num":
            self.next()
            return _num_key(v)
        if t in ("ident", "keyword"):
            self.next()
            return v
        raise self.error("expected property name")

    # ---- params ----------------------------------------------------------------

    def param_list(self):
        self.expect("punct", "(")
        params: list = []
        rest = None
        while not self.at("punct", ")"):
            if self.eat("punct", "..."):
                rest = self.ident_name()
                break
            pat = self.pattern()
            default = self.assignment() if self.eat("punct", "=") else None
            params.append((pat, default))
            if not self.at("punct", ")"):
                self.expect("punct", ",")
        self.expect("punct", ")")
        return params, rest

    # ---- expressions -----------------------------------------------------------

    def expression(self):
        expr = self.assignment()
        if self.at("punct", ","):
            exprs = [expr]
            while self.eat("punct", ","):
                exprs.append(self.assignment())
            return ("seq", exprs)
        return expr

    def assignment(self):
        arrow = self.try_arrow()
        if arrow is not None:
            return arrow
        left = self.conditional()
        t, v, _ = self.peek()
        if t == "punct" and v in ASSIGN_OPS:
            self.next()
            right = self.assignment()
            return ("assign", v, left, right)
        return left

    def try_arrow(self):
        """Backtracking arrow detection: [async] ident => …, or
        [async] ( params ) => …"""
        start = self.i
        is_async = False
        if self.at("keyword", "async") and not self.at("punct", "(", 1) and \
                (self.at("ident", None, 1)):
            # async x => …
            self.next()
            is_async = True
        elif self.at("keyword", "async") and self.at("punct", "(", 1):
            save = self.i
            self.next()
            if self._scan_parens_then_arrow():
                is_async = True
            else:
                self.i = start
                return None
            self.i = save + 1  # position at "("
            params, rest = self.param_list()
            self.expect("punct", "=>")
            return self.arrow_tail(params, rest, is_async)
        if self.at("ident") and self.at("punct", "=>", 1):
            name = self.ident_name()
            self.expect("punct", "=>")
            return self.arrow_tail([(("pid", name), None)], None, is_async)
        if is_async:  # async ident but no arrow — back out
            self.i = start
            return None
        if self.at("punct", "("):
            if not self._scan_parens_then_arrow():
                return None
            params, rest = self.param_list()
            self.expect("punct", "=>")
            return self.arrow_tail(params, rest, False)
        return None

    def _scan_parens_then_arrow(self) -> bool:
        """From a '(' token, check whether the matching ')' is followed by
        '=>' (pure lookahead, no state change)."""
        j = self.i
        depth = 0
        while j < len(self.toks):
            t, v, _ = self.toks[j]
            if t == "punct" and v in ("(", "[", "{"):
                depth += 1
            elif t == "punct" and v in (")", "]", "}"):
                depth -= 1
                if depth == 0:
                    nt, nv, _ = self.toks[j + 1] if j + 1 < len(self.toks) \
                        else ("eof", None, 0)
                    return nt == "punct" and nv == "=>"
            elif t == "eof":
                return False
            j += 1
        return False

    def arrow_tail(self, params, rest, is_async: bool):
        if self.at("punct", "{"):
            return ("arrow", params, rest, self.block(), False, is_async)
        return ("arrow", params, rest, self.assignment(), True, is_async)

    def conditional(self):
        cond = self.binary(1)
        if self.eat("punct", "?"):
            a = self.assignment()
            self.expect("punct", ":")
            b = self.assignment()
            return ("cond", cond, a, b)
        return cond

    def binary(self, min_prec: int):
        left = self.unary()
        while True:
            t, v, _ = self.peek()
            op = v if (t == "punct" or (t == "keyword" and v in ("instanceof", "in"))) else None
            prec = BINARY.get(op)
            if prec is None or prec < min_prec:
                return left
            self.next()
            right = self.binary(prec if op == "**" else prec + 1)
            left = ("logic" if op in ("&&", "||", "??") else "binop",
                    op, left, right)

    def unary(self):
        t, v, _ = self.peek()
        if t == "punct" and v in ("!", "-", "+", "~"):
            self.next()
            return ("unary", v, self.unary())
        if t == "punct" and v in ("++", "--"):
            self.next()
            return ("update", v, True, self.unary())
        if t == "keyword" and v in ("typeof", "delete", "void"):
            self.next()
            return ("unary", v, self.unary())
        if t == "keyword" and v == "await":
            self.next()
            return ("await", self.unary())
        return self.postfix()

    def postfix(self):
        expr = self.call_member(self.primary())
        t, v, _ = self.peek()
        if t == "punct" and v in ("++", "--"):
            self.next()
            return ("update", v, False, expr)
        return expr

    def call_member(self, expr):
        # Optional links (?.) mark the whole chain: one nullish base
        # short-circuits the REST of the chain (spec OptionalExpression),
        # which the interpreter implements by unwinding to the optchain
        # wrapper emitted here.
        has_opt = False
        while True:
            if self.eat("punct", "?."):
                has_opt = True
                if self.at("punct", "("):
                    expr = ("optcall", expr, self.arguments())
                elif self.eat("punct", "["):
                    idx = self.expression()
                    self.expect("punct", "]")
                    expr = ("optindex", expr, idx)
                else:
                    expr = ("optmember", expr, self.prop_name())
            elif self.eat("punct", "."):
                expr = ("member", expr, self.prop_name())
            elif self.at("punct", "["):
                self.next()
                idx = self.expression()
                self.expect("punct", "]")
                expr = ("index", expr, idx)
            elif self.at("punct", "("):
                expr = ("call", expr, self.arguments())
            else:
                return ("optchain", expr) if has_opt else expr

    def arguments(self):
        self.expect("punct", "(")
        args = []
        while not self.at("punct", ")"):
            if self.eat("punct", "..."):
                args.append(("spread", self.assignment()))
            else:
                args.append(self.assignment())
            if not self.at("punct", ")"):
                self.expect("punct", ",")
        self.expect("punct", ")")
        return args

    def primary(self):
        t, v, line = self.peek()
        if t == "num":
            self.next()
            return ("num", v)
        if t == "str":
            self.next()
            return ("str", v)
        if t == "template":
            self.next()
            parts = []
            for kind, payload in v:
                if kind == "str":
                    parts.append(("str", payload))
                else:
                    parts.append(("expr", Parser(payload, self.filename).expression()))
            return ("template", parts)
        if t == "regex":
            self.next()
            return ("regex", v[0], v[1])
        if t == "ident":
            self.next()
            return ("ident", v)
        if t == "keyword":
            if v == "this":
                self.next()
                return ("this",)
            if v == "null":
                self.next()
                return ("null",)
            if v == "undefined":
                self.next()
                return ("undef",)
            if v in ("true", "false"):
                self.next()
                return ("bool", v == "true")
            if v == "new":
                self.next()
                callee = self.call_member_no_call(self.primary())
                args = self.arguments() if self.at("punct", "(") else []
                return self.call_member(("new", callee, args))
            if v == "function":
                return self.func_expr(is_async=False)
            if v == "async" and self.at("keyword", "function", 1):
                self.next()
                return self.func_expr(is_async=True)
            if v in ("get", "set", "of", "async", "undefined"):
                # contextual keyword as plain identifier
                self.next()
                return ("ident", v)
        if t == "punct" and v == "(":
            self.next()
            expr = self.expression()
            self.expect("punct", ")")
            return expr
        if t == "punct" and v == "[":
            return self.array_literal()
        if t == "punct" and v == "{":
            return self.object_literal()
        raise self.error("unexpected token")

    def call_member_no_call(self, expr):
        """Member chain without calls — `new a.b.C(...)` binds the
        arguments to the constructor, not to `a.b`."""
        while True:
            if self.eat("punct", "."):
                expr = ("member", expr, self.prop_name())
            elif self.at("punct", "["):
                self.next()
                idx = self.expression()
                self.expect("punct", "]")
                expr = ("index", expr, idx)
            else:
                return expr

    def func_expr(self, is_async: bool):
        self.expect("keyword", "function")
        name = None
        if self.at("ident"):
            name = self.ident_name()
        params, rest = self.param_list()
        body = self.block()
        return ("func", name, params, rest, body, is_async)

    def array_literal(self):
        self.expect("punct", "[")
        elems = []
        while not self.at("punct", "]"):
            if self.at("punct", ","):
                self.next()
                elems.append(("hole",))
                continue
            if self.eat("punct", "..."):
                elems.append(("spread", self.assignment()))
            else:
                elems.append(self.assignment())
            if not self.at("punct", "]"):
                self.expect("punct", ",")
        self.expect("punct", "]")
        return ("array", elems)

    def object_literal(self):
        self.expect("punct", "{")
        props = []
        while not self.at("punct", "}"):
            if self.eat("punct", "..."):
                props.append(("spread", self.assignment()))
            else:
                props.append(self.object_prop())
            if not self.at("punct", "}"):
                self.expect("punct", ",")
        self.expect("punct", "}")
        return ("object", props)

    def object_prop(self):
        t, v, _ = self.peek()
        # get name() {} / set name(v) {}
        if t == "keyword" and v in ("get", "set") and not (
                self.at("punct", ":", 1) or self.at("punct", ",", 1) or
                self.at("punct", "(", 1) or self.at("punct", "}", 1)):
            self.next()
            key = self.prop_name()
            params, rest = self.param_list()
            body = self.block()
            if v == "get":
                return ("getter", key, body)
            return ("setter", key, params[0][0], body)
        is_async = False
        if t == "keyword" and v == "async" and not (
                self.at("punct", ":", 1) or self.at("punct", ",", 1) or
                self.at("punct", "(", 1) or self.at("punct", "}", 1)):
            self.next()
            is_async = True
        key = self.prop_name()
        if self.at("punct", "("):  # method shorthand
            params, rest = self.param_list()
            body = self.block()
            return ("method", key, params, rest, body, is_async)
        if self.eat("punct", ":"):
            return ("prop", key, self.assignment())
        return ("shorthand", key)


def _num_key(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


def parse(src: str, filename: str = "<js>"):
    return Parser(tokenize(src, filename), filename).parse_program()
