"""tokenizer.json patterns on the standard library's ``re``.

tokenizer.json split patterns are written for the ``regex`` module: they use
``\\p{L}``, ``\\p{N}``, ``\\p{P}``, ``\\s`` and ``\\w`` as ``regex`` defines
them. Stdlib ``re`` has no ``\\p{..}``; its ``\\s`` also matches
U+001C-U+001F, which ``regex``'s (Unicode White_Space) does not; and Python's
``unicodedata`` may be older than ``regex``'s tables (``unicodedata`` 15.0
leaves 9,568 of ``regex``'s letters and 93 of its digits unassigned). So the
classes are kept below as literal code point ranges taken from ``regex``, and
``translate`` rewrites a pattern into one that stdlib ``re`` matches the same
way.

``translate`` raises ``UntranslatablePattern`` on any construct whose meaning
it cannot reproduce exactly; it never hands back a different pattern. Under a
case-insensitive flag it takes only ASCII literals other than ``i``/``I``
(whose case partners both libraries agree on), and no class.

The tables are generated. With the ``regex`` module installed,

    python -m transformers_tpu_torch.tokenization.unicode_classes

rewrites them from ``regex``'s classes over all 0x110000 code points.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

MAX_CODE_POINT = 0x10FFFF

# The pattern each table is taken from, in the ``regex`` module.
SOURCES = {"L": r"\p{L}", "N": r"\p{N}", "P": r"\p{P}", "s": r"\s", "w": r"\w"}
# The escapes that name a table: \p{X} and \P{X} for these X, and \s, \S, \w, \W.
_PROPERTY_NAMES = ("L", "N", "P")
# ASCII letters whose case partners differ between ``re`` and ``regex``
# (``regex`` folds U+0131 with "i", ``re`` U+0130 with "I").
_CASE_UNSAFE = frozenset("iI")
# Escapes that mean the same character or anchor in both libraries.
_SIMPLE_ESCAPES = frozenset("tnrfva")
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLAGS = frozenset("ims")


class UntranslatablePattern(ValueError):
    """A pattern that stdlib ``re`` cannot be made to match as ``regex`` does."""


@functools.cache
def ranges(name: str) -> tuple:
    """The code point ranges (first, last) of table ``name`` (a key of SOURCES)."""
    out = []
    for item in _TABLES[name].split():
        first, _, last = item.partition("-")
        out.append((int(first, 16), int(last or first, 16)))
    return tuple(out)


def complement(spans) -> tuple:
    out, start = [], 0
    for first, last in spans:
        if first > start:
            out.append((start, first - 1))
        start = last + 1
    if start <= MAX_CODE_POINT:
        out.append((start, MAX_CODE_POINT))
    return tuple(out)


def _escape(cp: int) -> str:
    return f"\\u{cp:04x}" if cp < 0x10000 else f"\\U{cp:08x}"


@functools.cache
def class_body(name: str, negated: bool = False) -> str:
    """Table ``name`` (or its complement) as the inside of a ``re`` character class."""
    spans = complement(ranges(name)) if negated else ranges(name)
    return "".join(_escape(a) if a == b else f"{_escape(a)}-{_escape(b)}" for a, b in spans)


class _Translator:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.out: list[str] = []
        self.leading = True  # nothing but global flag groups emitted so far

    def fail(self, what: str):
        raise UntranslatablePattern(f"{what} at offset {self.i} of {self.p!r}")

    def table_escape(self, ch: str):
        """The (table, negated) that escape letter ``ch`` names at the cursor
        (just past it), consuming a ``{X}`` or ``X`` property name; else None."""
        if ch in "sSwW":
            return ch.lower(), ch.isupper()
        if ch not in "pP":
            return None
        if self.p.startswith("{", self.i):
            end = self.p.find("}", self.i)
            if end < 0:
                self.fail("unterminated property")
            name, self.i = self.p[self.i + 1:end], end + 1
        else:
            name, self.i = self.p[self.i:self.i + 1], self.i + 1
        if name.startswith("^"):  # \p{^L} is \P{L}
            name, ch = name[1:], "P" if ch == "p" else "p"
        if name not in _PROPERTY_NAMES:
            self.fail(f"property \\{ch}{{{name}}}")
        return name, ch == "P"

    def literal_escape(self, ch: str, start: int, folding: bool, in_class: bool) -> str:
        """Source text of a one-character escape (cursor past ``ch``)."""
        if ch in _HEX_ESCAPES:
            n = _HEX_ESCAPES[ch]
            digits = self.p[self.i:self.i + n]
            if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
                self.fail(f"escape \\{ch} without {n} hex digits")
            self.i += n
            self.check_case(chr(int(digits, 16)), folding)
        elif ch in _SIMPLE_ESCAPES or (ch in "AZ" and not in_class):
            pass
        elif ch.isalnum() or ch == "_" or not ch.isascii():
            self.fail(f"escape \\{ch}")
        else:
            self.check_case(ch, folding)
        return self.p[start:self.i]

    def check_case(self, ch: str, folding: bool):
        if folding and (not ch.isascii() or ch in _CASE_UNSAFE):
            self.fail(f"case-insensitive {ch!r}")

    def char_class(self, folding: bool):
        """From just past ``[`` to just past its ``]``."""
        if folding:
            self.fail("character class under a case-insensitive flag")
        p, parts = self.p, ["["]
        if p.startswith("^", self.i):
            parts.append("^")
            self.i += 1
        if p.startswith("]", self.i):
            self.fail("']' first in a class")
        while True:
            if self.i >= len(p):
                self.fail("unterminated class")
            ch = p[self.i]
            if ch == "]":
                self.i += 1
                parts.append("]")
                break
            if ch == "[" or p[self.i:self.i + 2] in ("&&", "--", "||", "~~"):
                self.fail("nested set or set operation")
            start = self.i
            self.i += 1
            if ch != "\\":
                parts.append(ch)
                continue
            if self.i >= len(p):
                self.fail("trailing backslash")
            esc = p[self.i]
            self.i += 1
            table = self.table_escape(esc)
            if table is not None:
                parts.append(class_body(*table))
            else:
                parts.append(self.literal_escape(esc, start, False, True))
        self.out.append("".join(parts))

    def group(self, stack: list, scope: bool):
        """From just past ``(``: pushes the group's case state onto ``stack``.
        Returns the global case flag that a ``(?i)`` at the start sets, else None."""
        p = self.p
        if not p.startswith("?", self.i):
            stack.append(scope)
            self.out.append("(")
            return None
        rest = p[self.i + 1:]
        for opener in (":", "=", "!", "<=", "<!", ">"):
            if rest.startswith(opener):
                stack.append(scope)
                self.out.append("(?" + opener)
                self.i += 1 + len(opener)
                return None
        if rest.startswith("P<"):
            end = p.find(">", self.i)
            if end < 0:
                self.fail("unterminated group name")
            stack.append(scope)
            self.out.append("(" + p[self.i:end + 1])
            self.i = end + 1
            return None
        m = re.match(r"([a-z]*)(?:-([a-z]*))?([:)])", rest)
        on, off = (m.group(1), m.group(2) or "") if m else ("", "")
        if not (on or off) or not set(on + off) <= _FLAGS:
            self.fail("group construct")
        self.i += 1 + m.end()
        self.out.append("(?" + m.group(0))
        flagged = ("i" in on) or (scope and "i" not in off)
        if m.group(3) == ":":
            stack.append(flagged)
            return None
        if off or stack or not self.leading:  # re takes global flags only at the start
            self.fail("global flags after the start")
        return flagged

    def run(self) -> str:
        p = self.p
        stack: list[bool] = []  # the case-insensitive flag of each open group
        folding = False  # the global case-insensitive flag
        while self.i < len(p):
            scope = stack[-1] if stack else folding
            ch = p[self.i]
            start = self.i
            self.i += 1
            if ch == "\\":
                if self.i >= len(p):
                    self.fail("trailing backslash")
                esc = p[self.i]
                self.i += 1
                table = self.table_escape(esc)
                if table is not None:
                    if scope:
                        self.fail("class escape under a case-insensitive flag")
                    self.out.append(f"[{'^' if table[1] else ''}{class_body(table[0])}]")
                else:
                    self.out.append(self.literal_escape(esc, start, scope, False))
            elif ch == "[":
                self.char_class(scope)
            elif ch == "(":
                flag = self.group(stack, scope)
                if flag is not None:
                    folding = flag
                    continue  # still at the start
            elif ch == ")":
                if not stack:
                    self.fail("unbalanced ')'")
                stack.pop()
                self.out.append(ch)
            else:
                if ch not in ".|^$*+?{},":
                    self.check_case(ch, scope)
                self.out.append(ch)
            self.leading = False
        if stack:
            self.fail("unbalanced '('")
        return "".join(self.out)


@functools.lru_cache(maxsize=64)
def translate(pattern: str) -> str:
    """``pattern`` (``regex`` syntax) rewritten for stdlib ``re``; raises
    ``UntranslatablePattern`` where it cannot be made exact."""
    return _Translator(pattern).run()


@functools.lru_cache(maxsize=64)
def compile(pattern: str) -> re.Pattern:  # noqa: A001 - mirrors re.compile
    return re.compile(translate(pattern))


def _render(tables: dict) -> str:
    lines = ["_TABLES = {"]
    for name, spans in tables.items():
        items = [f"{a:04X}" if a == b else f"{a:04X}-{b:04X}" for a, b in spans]
        lines.append(f"    {name!r}: (  # regex {SOURCES[name]}: {len(spans)} ranges, "
                     f"{sum(b - a + 1 for a, b in spans)} code points")
        row = ""
        for item in items:
            if len(row) + len(item) + 1 > 86:
                lines.append(f'        "{row}"')
                row = ""
            row += item + " "
        lines.append(f'        "{row}"')
        lines.append("    ),")
    lines.append("}")
    return "\n".join(lines) + "\n"


def regenerate() -> None:
    """Rewrite this file's tables from the ``regex`` module's classes."""
    import regex

    text = "".join(chr(c) for c in range(MAX_CODE_POINT + 1))
    tables = {}
    for name, source in SOURCES.items():
        spans = [(m.start(), m.end() - 1) for m in regex.finditer(f"(?:{source})+", text)]
        tables[name] = tuple(spans)
    path = Path(__file__)
    src = path.read_text(encoding="utf-8")
    head, marker, _ = src.partition("\n" + _MARKER + "\n")
    path.write_text(head + marker + _render(tables), encoding="utf-8")


_MARKER = "# ---- generated by regenerate(): do not edit below ----"

if __name__ == "__main__":
    regenerate()

# ---- generated by regenerate(): do not edit below ----
_TABLES = {
    'L': (  # regex \p{L}: 684 ranges, 145672 code points
        "0041-005A 0061-007A 00AA 00B5 00BA 00C0-00D6 00D8-00F6 00F8-02C1 02C6-02D1 02E0-02E4 "
        "02EC 02EE 0370-0374 0376-0377 037A-037D 037F 0386 0388-038A 038C 038E-03A1 03A3-03F5 "
        "03F7-0481 048A-052F 0531-0556 0559 0560-0588 05D0-05EA 05EF-05F2 0620-064A 066E-066F "
        "0671-06D3 06D5 06E5-06E6 06EE-06EF 06FA-06FC 06FF 0710 0712-072F 074D-07A5 07B1 "
        "07CA-07EA 07F4-07F5 07FA 0800-0815 081A 0824 0828 0840-0858 0860-086A 0870-0887 "
        "0889-088F 08A0-08C9 0904-0939 093D 0950 0958-0961 0971-0980 0985-098C 098F-0990 "
        "0993-09A8 09AA-09B0 09B2 09B6-09B9 09BD 09CE 09DC-09DD 09DF-09E1 09F0-09F1 09FC "
        "0A05-0A0A 0A0F-0A10 0A13-0A28 0A2A-0A30 0A32-0A33 0A35-0A36 0A38-0A39 0A59-0A5C 0A5E "
        "0A72-0A74 0A85-0A8D 0A8F-0A91 0A93-0AA8 0AAA-0AB0 0AB2-0AB3 0AB5-0AB9 0ABD 0AD0 "
        "0AE0-0AE1 0AF9 0B05-0B0C 0B0F-0B10 0B13-0B28 0B2A-0B30 0B32-0B33 0B35-0B39 0B3D "
        "0B5C-0B5D 0B5F-0B61 0B71 0B83 0B85-0B8A 0B8E-0B90 0B92-0B95 0B99-0B9A 0B9C 0B9E-0B9F "
        "0BA3-0BA4 0BA8-0BAA 0BAE-0BB9 0BD0 0C05-0C0C 0C0E-0C10 0C12-0C28 0C2A-0C39 0C3D "
        "0C58-0C5A 0C5C-0C5D 0C60-0C61 0C80 0C85-0C8C 0C8E-0C90 0C92-0CA8 0CAA-0CB3 0CB5-0CB9 "
        "0CBD 0CDC-0CDE 0CE0-0CE1 0CF1-0CF2 0D04-0D0C 0D0E-0D10 0D12-0D3A 0D3D 0D4E 0D54-0D56 "
        "0D5F-0D61 0D7A-0D7F 0D85-0D96 0D9A-0DB1 0DB3-0DBB 0DBD 0DC0-0DC6 0E01-0E30 0E32-0E33 "
        "0E40-0E46 0E81-0E82 0E84 0E86-0E8A 0E8C-0EA3 0EA5 0EA7-0EB0 0EB2-0EB3 0EBD 0EC0-0EC4 "
        "0EC6 0EDC-0EDF 0F00 0F40-0F47 0F49-0F6C 0F88-0F8C 1000-102A 103F 1050-1055 105A-105D "
        "1061 1065-1066 106E-1070 1075-1081 108E 10A0-10C5 10C7 10CD 10D0-10FA 10FC-1248 "
        "124A-124D 1250-1256 1258 125A-125D 1260-1288 128A-128D 1290-12B0 12B2-12B5 12B8-12BE "
        "12C0 12C2-12C5 12C8-12D6 12D8-1310 1312-1315 1318-135A 1380-138F 13A0-13F5 13F8-13FD "
        "1401-166C 166F-167F 1681-169A 16A0-16EA 16F1-16F8 1700-1711 171F-1731 1740-1751 "
        "1760-176C 176E-1770 1780-17B3 17D7 17DC 1820-1878 1880-1884 1887-18A8 18AA 18B0-18F5 "
        "1900-191E 1950-196D 1970-1974 1980-19AB 19B0-19C9 1A00-1A16 1A20-1A54 1AA7 1B05-1B33 "
        "1B45-1B4C 1B83-1BA0 1BAE-1BAF 1BBA-1BE5 1C00-1C23 1C4D-1C4F 1C5A-1C7D 1C80-1C8A "
        "1C90-1CBA 1CBD-1CBF 1CE9-1CEC 1CEE-1CF3 1CF5-1CF6 1CFA 1D00-1DBF 1E00-1F15 1F18-1F1D "
        "1F20-1F45 1F48-1F4D 1F50-1F57 1F59 1F5B 1F5D 1F5F-1F7D 1F80-1FB4 1FB6-1FBC 1FBE "
        "1FC2-1FC4 1FC6-1FCC 1FD0-1FD3 1FD6-1FDB 1FE0-1FEC 1FF2-1FF4 1FF6-1FFC 2071 207F "
        "2090-209C 2102 2107 210A-2113 2115 2119-211D 2124 2126 2128 212A-212D 212F-2139 "
        "213C-213F 2145-2149 214E 2183-2184 2C00-2CE4 2CEB-2CEE 2CF2-2CF3 2D00-2D25 2D27 2D2D "
        "2D30-2D67 2D6F 2D80-2D96 2DA0-2DA6 2DA8-2DAE 2DB0-2DB6 2DB8-2DBE 2DC0-2DC6 2DC8-2DCE "
        "2DD0-2DD6 2DD8-2DDE 2E2F 3005-3006 3031-3035 303B-303C 3041-3096 309D-309F 30A1-30FA "
        "30FC-30FF 3105-312F 3131-318E 31A0-31BF 31F0-31FF 3400-4DBF 4E00-A48C A4D0-A4FD "
        "A500-A60C A610-A61F A62A-A62B A640-A66E A67F-A69D A6A0-A6E5 A717-A71F A722-A788 "
        "A78B-A7DC A7F1-A801 A803-A805 A807-A80A A80C-A822 A840-A873 A882-A8B3 A8F2-A8F7 A8FB "
        "A8FD-A8FE A90A-A925 A930-A946 A960-A97C A984-A9B2 A9CF A9E0-A9E4 A9E6-A9EF A9FA-A9FE "
        "AA00-AA28 AA40-AA42 AA44-AA4B AA60-AA76 AA7A AA7E-AAAF AAB1 AAB5-AAB6 AAB9-AABD AAC0 "
        "AAC2 AADB-AADD AAE0-AAEA AAF2-AAF4 AB01-AB06 AB09-AB0E AB11-AB16 AB20-AB26 AB28-AB2E "
        "AB30-AB5A AB5C-AB69 AB70-ABE2 AC00-D7A3 D7B0-D7C6 D7CB-D7FB F900-FA6D FA70-FAD9 "
        "FB00-FB06 FB13-FB17 FB1D FB1F-FB28 FB2A-FB36 FB38-FB3C FB3E FB40-FB41 FB43-FB44 "
        "FB46-FBB1 FBD3-FD3D FD50-FD8F FD92-FDC7 FDF0-FDFB FE70-FE74 FE76-FEFC FF21-FF3A "
        "FF41-FF5A FF66-FFBE FFC2-FFC7 FFCA-FFCF FFD2-FFD7 FFDA-FFDC 10000-1000B 1000D-10026 "
        "10028-1003A 1003C-1003D 1003F-1004D 10050-1005D 10080-100FA 10280-1029C 102A0-102D0 "
        "10300-1031F 1032D-10340 10342-10349 10350-10375 10380-1039D 103A0-103C3 103C8-103CF "
        "10400-1049D 104B0-104D3 104D8-104FB 10500-10527 10530-10563 10570-1057A 1057C-1058A "
        "1058C-10592 10594-10595 10597-105A1 105A3-105B1 105B3-105B9 105BB-105BC 105C0-105F3 "
        "10600-10736 10740-10755 10760-10767 10780-10785 10787-107B0 107B2-107BA 10800-10805 "
        "10808 1080A-10835 10837-10838 1083C 1083F-10855 10860-10876 10880-1089E 108E0-108F2 "
        "108F4-108F5 10900-10915 10920-10939 10940-10959 10980-109B7 109BE-109BF 10A00 "
        "10A10-10A13 10A15-10A17 10A19-10A35 10A60-10A7C 10A80-10A9C 10AC0-10AC7 10AC9-10AE4 "
        "10B00-10B35 10B40-10B55 10B60-10B72 10B80-10B91 10C00-10C48 10C80-10CB2 10CC0-10CF2 "
        "10D00-10D23 10D4A-10D65 10D6F-10D85 10E80-10EA9 10EB0-10EB1 10EC2-10EC7 10F00-10F1C "
        "10F27 10F30-10F45 10F70-10F81 10FB0-10FC4 10FE0-10FF6 11003-11037 11071-11072 11075 "
        "11083-110AF 110D0-110E8 11103-11126 11144 11147 11150-11172 11176 11183-111B2 "
        "111C1-111C4 111DA 111DC 11200-11211 11213-1122B 1123F-11240 11280-11286 11288 "
        "1128A-1128D 1128F-1129D 1129F-112A8 112B0-112DE 11305-1130C 1130F-11310 11313-11328 "
        "1132A-11330 11332-11333 11335-11339 1133D 11350 1135D-11361 11380-11389 1138B 1138E "
        "11390-113B5 113B7 113D1 113D3 11400-11434 11447-1144A 1145F-11461 11480-114AF "
        "114C4-114C5 114C7 11580-115AE 115D8-115DB 11600-1162F 11644 11680-116AA 116B8 "
        "11700-1171A 11740-11746 11800-1182B 118A0-118DF 118FF-11906 11909 1190C-11913 "
        "11915-11916 11918-1192F 1193F 11941 119A0-119A7 119AA-119D0 119E1 119E3 11A00 "
        "11A0B-11A32 11A3A 11A50 11A5C-11A89 11A9D 11AB0-11AF8 11BC0-11BE0 11C00-11C08 "
        "11C0A-11C2E 11C40 11C72-11C8F 11D00-11D06 11D08-11D09 11D0B-11D30 11D46 11D60-11D65 "
        "11D67-11D68 11D6A-11D89 11D98 11DB0-11DDB 11EE0-11EF2 11F02 11F04-11F10 11F12-11F33 "
        "11FB0 12000-12399 12480-12543 12F90-12FF0 13000-1342F 13441-13446 13460-143FA "
        "14400-14646 16100-1611D 16800-16A38 16A40-16A5E 16A70-16ABE 16AD0-16AED 16B00-16B2F "
        "16B40-16B43 16B63-16B77 16B7D-16B8F 16D40-16D6C 16E40-16E7F 16EA0-16EB8 16EBB-16ED3 "
        "16F00-16F4A 16F50 16F93-16F9F 16FE0-16FE1 16FE3 16FF2-16FF3 17000-18CD5 18CFF-18D1E "
        "18D80-18DF2 1AFF0-1AFF3 1AFF5-1AFFB 1AFFD-1AFFE 1B000-1B122 1B132 1B150-1B152 1B155 "
        "1B164-1B167 1B170-1B2FB 1BC00-1BC6A 1BC70-1BC7C 1BC80-1BC88 1BC90-1BC99 1D400-1D454 "
        "1D456-1D49C 1D49E-1D49F 1D4A2 1D4A5-1D4A6 1D4A9-1D4AC 1D4AE-1D4B9 1D4BB 1D4BD-1D4C3 "
        "1D4C5-1D505 1D507-1D50A 1D50D-1D514 1D516-1D51C 1D51E-1D539 1D53B-1D53E 1D540-1D544 "
        "1D546 1D54A-1D550 1D552-1D6A5 1D6A8-1D6C0 1D6C2-1D6DA 1D6DC-1D6FA 1D6FC-1D714 "
        "1D716-1D734 1D736-1D74E 1D750-1D76E 1D770-1D788 1D78A-1D7A8 1D7AA-1D7C2 1D7C4-1D7CB "
        "1DF00-1DF1E 1DF25-1DF2A 1E030-1E06D 1E100-1E12C 1E137-1E13D 1E14E 1E290-1E2AD "
        "1E2C0-1E2EB 1E4D0-1E4EB 1E5D0-1E5ED 1E5F0 1E6C0-1E6DE 1E6E0-1E6E2 1E6E4-1E6E5 "
        "1E6E7-1E6ED 1E6F0-1E6F4 1E6FE-1E6FF 1E7E0-1E7E6 1E7E8-1E7EB 1E7ED-1E7EE 1E7F0-1E7FE "
        "1E800-1E8C4 1E900-1E943 1E94B 1EE00-1EE03 1EE05-1EE1F 1EE21-1EE22 1EE24 1EE27 "
        "1EE29-1EE32 1EE34-1EE37 1EE39 1EE3B 1EE42 1EE47 1EE49 1EE4B 1EE4D-1EE4F 1EE51-1EE52 "
        "1EE54 1EE57 1EE59 1EE5B 1EE5D 1EE5F 1EE61-1EE62 1EE64 1EE67-1EE6A 1EE6C-1EE72 "
        "1EE74-1EE77 1EE79-1EE7C 1EE7E 1EE80-1EE89 1EE8B-1EE9B 1EEA1-1EEA3 1EEA5-1EEA9 "
        "1EEAB-1EEBB 20000-2A6DF 2A700-2B81D 2B820-2CEAD 2CEB0-2EBE0 2EBF0-2EE5D 2F800-2FA1D "
        "30000-3134A 31350-33479 "
    ),
    'N': (  # regex \p{N}: 146 ranges, 1924 code points
        "0030-0039 00B2-00B3 00B9 00BC-00BE 0660-0669 06F0-06F9 07C0-07C9 0966-096F 09E6-09EF "
        "09F4-09F9 0A66-0A6F 0AE6-0AEF 0B66-0B6F 0B72-0B77 0BE6-0BF2 0C66-0C6F 0C78-0C7E "
        "0CE6-0CEF 0D58-0D5E 0D66-0D78 0DE6-0DEF 0E50-0E59 0ED0-0ED9 0F20-0F33 1040-1049 "
        "1090-1099 1369-137C 16EE-16F0 17E0-17E9 17F0-17F9 1810-1819 1946-194F 19D0-19DA "
        "1A80-1A89 1A90-1A99 1B50-1B59 1BB0-1BB9 1C40-1C49 1C50-1C59 2070 2074-2079 2080-2089 "
        "2150-2182 2185-2189 2460-249B 24EA-24FF 2776-2793 2CFD 3007 3021-3029 3038-303A "
        "3192-3195 3220-3229 3248-324F 3251-325F 3280-3289 32B1-32BF A620-A629 A6E6-A6EF "
        "A830-A835 A8D0-A8D9 A900-A909 A9D0-A9D9 A9F0-A9F9 AA50-AA59 ABF0-ABF9 FF10-FF19 "
        "10107-10133 10140-10178 1018A-1018B 102E1-102FB 10320-10323 10341 1034A 103D1-103D5 "
        "104A0-104A9 10858-1085F 10879-1087F 108A7-108AF 108FB-108FF 10916-1091B 109BC-109BD "
        "109C0-109CF 109D2-109FF 10A40-10A48 10A7D-10A7E 10A9D-10A9F 10AEB-10AEF 10B58-10B5F "
        "10B78-10B7F 10BA9-10BAF 10CFA-10CFF 10D30-10D39 10D40-10D49 10E60-10E7E 10F1D-10F26 "
        "10F51-10F54 10FC5-10FCB 11052-1106F 110F0-110F9 11136-1113F 111D0-111D9 111E1-111F4 "
        "112F0-112F9 11450-11459 114D0-114D9 11650-11659 116C0-116C9 116D0-116E3 11730-1173B "
        "118E0-118F2 11950-11959 11BF0-11BF9 11C50-11C6C 11D50-11D59 11DA0-11DA9 11DE0-11DE9 "
        "11F50-11F59 11FC0-11FD4 12400-1246E 16130-16139 16A60-16A69 16AC0-16AC9 16B50-16B59 "
        "16B5B-16B61 16D70-16D79 16E80-16E96 16FF4-16FF6 1CCF0-1CCF9 1D2C0-1D2D3 1D2E0-1D2F3 "
        "1D360-1D378 1D7CE-1D7FF 1E140-1E149 1E2F0-1E2F9 1E4F0-1E4F9 1E5F1-1E5FA 1E8C7-1E8CF "
        "1E950-1E959 1EC71-1ECAB 1ECAD-1ECAF 1ECB1-1ECB4 1ED01-1ED2D 1ED2F-1ED3D 1F100-1F10C "
        "1FBF0-1FBF9 "
    ),
    'P': (  # regex \p{P}: 199 ranges, 856 code points
        "0021-0023 0025-002A 002C-002F 003A-003B 003F-0040 005B-005D 005F 007B 007D 00A1 00A7 "
        "00AB 00B6-00B7 00BB 00BF 037E 0387 055A-055F 0589-058A 05BE 05C0 05C3 05C6 05F3-05F4 "
        "0609-060A 060C-060D 061B 061D-061F 066A-066D 06D4 0700-070D 07F7-07F9 0830-083E 085E "
        "0964-0965 0970 09FD 0A76 0AF0 0C77 0C84 0DF4 0E4F 0E5A-0E5B 0F04-0F12 0F14 0F3A-0F3D "
        "0F85 0FD0-0FD4 0FD9-0FDA 104A-104F 10FB 1360-1368 1400 166E 169B-169C 16EB-16ED "
        "1735-1736 17D4-17D6 17D8-17DA 1800-180A 1944-1945 1A1E-1A1F 1AA0-1AA6 1AA8-1AAD "
        "1B4E-1B4F 1B5A-1B60 1B7D-1B7F 1BFC-1BFF 1C3B-1C3F 1C7E-1C7F 1CC0-1CC7 1CD3 2010-2027 "
        "2030-2043 2045-2051 2053-205E 207D-207E 208D-208E 2308-230B 2329-232A 2768-2775 "
        "27C5-27C6 27E6-27EF 2983-2998 29D8-29DB 29FC-29FD 2CF9-2CFC 2CFE-2CFF 2D70 2E00-2E2E "
        "2E30-2E4F 2E52-2E5D 3001-3003 3008-3011 3014-301F 3030 303D 30A0 30FB A4FE-A4FF "
        "A60D-A60F A673 A67E A6F2-A6F7 A874-A877 A8CE-A8CF A8F8-A8FA A8FC A92E-A92F A95F "
        "A9C1-A9CD A9DE-A9DF AA5C-AA5F AADE-AADF AAF0-AAF1 ABEB FD3E-FD3F FE10-FE19 FE30-FE52 "
        "FE54-FE61 FE63 FE68 FE6A-FE6B FF01-FF03 FF05-FF0A FF0C-FF0F FF1A-FF1B FF1F-FF20 "
        "FF3B-FF3D FF3F FF5B FF5D FF5F-FF65 10100-10102 1039F 103D0 1056F 10857 1091F 1093F "
        "10A50-10A58 10A7F 10AF0-10AF6 10B39-10B3F 10B99-10B9C 10D6E 10EAD 10ED0 10F55-10F59 "
        "10F86-10F89 11047-1104D 110BB-110BC 110BE-110C1 11140-11143 11174-11175 111C5-111C8 "
        "111CD 111DB 111DD-111DF 11238-1123D 112A9 113D4-113D5 113D7-113D8 1144B-1144F "
        "1145A-1145B 1145D 114C6 115C1-115D7 11641-11643 11660-1166C 116B9 1173C-1173E 1183B "
        "11944-11946 119E2 11A3F-11A46 11A9A-11A9C 11A9E-11AA2 11B00-11B09 11BE1 11C41-11C45 "
        "11C70-11C71 11EF7-11EF8 11F43-11F4F 11FFF 12470-12474 12FF1-12FF2 16A6E-16A6F 16AF5 "
        "16B37-16B3B 16B44 16D6D-16D6F 16E97-16E9A 16FE2 1BC9F 1DA87-1DA8B 1E5FF 1E95E-1E95F "
    ),
    's': (  # regex \s: 10 ranges, 25 code points
        "0009-000D 0020 0085 00A0 1680 2000-200A 2028-2029 202F 205F 3000 "
    ),
    'w': (  # regex \w: 802 ranges, 149366 code points
        "0030-0039 0041-005A 005F 0061-007A 00AA 00B5 00BA 00C0-00D6 00D8-00F6 00F8-02C1 "
        "02C6-02D1 02E0-02E4 02EC 02EE 0300-0374 0376-0377 037A-037D 037F 0386 0388-038A 038C "
        "038E-03A1 03A3-03F5 03F7-0481 0483-052F 0531-0556 0559 0560-0588 0591-05BD 05BF "
        "05C1-05C2 05C4-05C5 05C7 05D0-05EA 05EF-05F2 0610-061A 0620-0669 066E-06D3 06D5-06DC "
        "06DF-06E8 06EA-06FC 06FF 0710-074A 074D-07B1 07C0-07F5 07FA 07FD 0800-082D 0840-085B "
        "0860-086A 0870-0887 0889-088F 0897-08E1 08E3-0963 0966-096F 0971-0983 0985-098C "
        "098F-0990 0993-09A8 09AA-09B0 09B2 09B6-09B9 09BC-09C4 09C7-09C8 09CB-09CE 09D7 "
        "09DC-09DD 09DF-09E3 09E6-09F1 09FC 09FE 0A01-0A03 0A05-0A0A 0A0F-0A10 0A13-0A28 "
        "0A2A-0A30 0A32-0A33 0A35-0A36 0A38-0A39 0A3C 0A3E-0A42 0A47-0A48 0A4B-0A4D 0A51 "
        "0A59-0A5C 0A5E 0A66-0A75 0A81-0A83 0A85-0A8D 0A8F-0A91 0A93-0AA8 0AAA-0AB0 0AB2-0AB3 "
        "0AB5-0AB9 0ABC-0AC5 0AC7-0AC9 0ACB-0ACD 0AD0 0AE0-0AE3 0AE6-0AEF 0AF9-0AFF 0B01-0B03 "
        "0B05-0B0C 0B0F-0B10 0B13-0B28 0B2A-0B30 0B32-0B33 0B35-0B39 0B3C-0B44 0B47-0B48 "
        "0B4B-0B4D 0B55-0B57 0B5C-0B5D 0B5F-0B63 0B66-0B6F 0B71 0B82-0B83 0B85-0B8A 0B8E-0B90 "
        "0B92-0B95 0B99-0B9A 0B9C 0B9E-0B9F 0BA3-0BA4 0BA8-0BAA 0BAE-0BB9 0BBE-0BC2 0BC6-0BC8 "
        "0BCA-0BCD 0BD0 0BD7 0BE6-0BEF 0C00-0C0C 0C0E-0C10 0C12-0C28 0C2A-0C39 0C3C-0C44 "
        "0C46-0C48 0C4A-0C4D 0C55-0C56 0C58-0C5A 0C5C-0C5D 0C60-0C63 0C66-0C6F 0C80-0C83 "
        "0C85-0C8C 0C8E-0C90 0C92-0CA8 0CAA-0CB3 0CB5-0CB9 0CBC-0CC4 0CC6-0CC8 0CCA-0CCD "
        "0CD5-0CD6 0CDC-0CDE 0CE0-0CE3 0CE6-0CEF 0CF1-0CF3 0D00-0D0C 0D0E-0D10 0D12-0D44 "
        "0D46-0D48 0D4A-0D4E 0D54-0D57 0D5F-0D63 0D66-0D6F 0D7A-0D7F 0D81-0D83 0D85-0D96 "
        "0D9A-0DB1 0DB3-0DBB 0DBD 0DC0-0DC6 0DCA 0DCF-0DD4 0DD6 0DD8-0DDF 0DE6-0DEF 0DF2-0DF3 "
        "0E01-0E3A 0E40-0E4E 0E50-0E59 0E81-0E82 0E84 0E86-0E8A 0E8C-0EA3 0EA5 0EA7-0EBD "
        "0EC0-0EC4 0EC6 0EC8-0ECE 0ED0-0ED9 0EDC-0EDF 0F00 0F18-0F19 0F20-0F29 0F35 0F37 0F39 "
        "0F3E-0F47 0F49-0F6C 0F71-0F84 0F86-0F97 0F99-0FBC 0FC6 1000-1049 1050-109D 10A0-10C5 "
        "10C7 10CD 10D0-10FA 10FC-1248 124A-124D 1250-1256 1258 125A-125D 1260-1288 128A-128D "
        "1290-12B0 12B2-12B5 12B8-12BE 12C0 12C2-12C5 12C8-12D6 12D8-1310 1312-1315 1318-135A "
        "135D-135F 1380-138F 13A0-13F5 13F8-13FD 1401-166C 166F-167F 1681-169A 16A0-16EA "
        "16EE-16F8 1700-1715 171F-1734 1740-1753 1760-176C 176E-1770 1772-1773 1780-17D3 17D7 "
        "17DC-17DD 17E0-17E9 180B-180D 180F-1819 1820-1878 1880-18AA 18B0-18F5 1900-191E "
        "1920-192B 1930-193B 1946-196D 1970-1974 1980-19AB 19B0-19C9 19D0-19D9 1A00-1A1B "
        "1A20-1A5E 1A60-1A7C 1A7F-1A89 1A90-1A99 1AA7 1AB0-1ADD 1AE0-1AEB 1B00-1B4C 1B50-1B59 "
        "1B6B-1B73 1B80-1BF3 1C00-1C37 1C40-1C49 1C4D-1C7D 1C80-1C8A 1C90-1CBA 1CBD-1CBF "
        "1CD0-1CD2 1CD4-1CFA 1D00-1F15 1F18-1F1D 1F20-1F45 1F48-1F4D 1F50-1F57 1F59 1F5B 1F5D "
        "1F5F-1F7D 1F80-1FB4 1FB6-1FBC 1FBE 1FC2-1FC4 1FC6-1FCC 1FD0-1FD3 1FD6-1FDB 1FE0-1FEC "
        "1FF2-1FF4 1FF6-1FFC 200C-200D 203F-2040 2054 2071 207F 2090-209C 20D0-20F0 2102 2107 "
        "210A-2113 2115 2119-211D 2124 2126 2128 212A-212D 212F-2139 213C-213F 2145-2149 214E "
        "2160-2188 24B6-24E9 2C00-2CE4 2CEB-2CF3 2D00-2D25 2D27 2D2D 2D30-2D67 2D6F 2D7F-2D96 "
        "2DA0-2DA6 2DA8-2DAE 2DB0-2DB6 2DB8-2DBE 2DC0-2DC6 2DC8-2DCE 2DD0-2DD6 2DD8-2DDE "
        "2DE0-2DFF 2E2F 3005-3007 3021-302F 3031-3035 3038-303C 3041-3096 3099-309A 309D-309F "
        "30A1-30FA 30FC-30FF 3105-312F 3131-318E 31A0-31BF 31F0-31FF 3400-4DBF 4E00-A48C "
        "A4D0-A4FD A500-A60C A610-A62B A640-A672 A674-A67D A67F-A6F1 A717-A71F A722-A788 "
        "A78B-A7DC A7F1-A827 A82C A840-A873 A880-A8C5 A8D0-A8D9 A8E0-A8F7 A8FB A8FD-A92D "
        "A930-A953 A960-A97C A980-A9C0 A9CF-A9D9 A9E0-A9FE AA00-AA36 AA40-AA4D AA50-AA59 "
        "AA60-AA76 AA7A-AAC2 AADB-AADD AAE0-AAEF AAF2-AAF6 AB01-AB06 AB09-AB0E AB11-AB16 "
        "AB20-AB26 AB28-AB2E AB30-AB5A AB5C-AB69 AB70-ABEA ABEC-ABED ABF0-ABF9 AC00-D7A3 "
        "D7B0-D7C6 D7CB-D7FB F900-FA6D FA70-FAD9 FB00-FB06 FB13-FB17 FB1D-FB28 FB2A-FB36 "
        "FB38-FB3C FB3E FB40-FB41 FB43-FB44 FB46-FBB1 FBD3-FD3D FD50-FD8F FD92-FDC7 FDF0-FDFB "
        "FE00-FE0F FE20-FE2F FE33-FE34 FE4D-FE4F FE70-FE74 FE76-FEFC FF10-FF19 FF21-FF3A FF3F "
        "FF41-FF5A FF66-FFBE FFC2-FFC7 FFCA-FFCF FFD2-FFD7 FFDA-FFDC 10000-1000B 1000D-10026 "
        "10028-1003A 1003C-1003D 1003F-1004D 10050-1005D 10080-100FA 10140-10174 101FD "
        "10280-1029C 102A0-102D0 102E0 10300-1031F 1032D-1034A 10350-1037A 10380-1039D "
        "103A0-103C3 103C8-103CF 103D1-103D5 10400-1049D 104A0-104A9 104B0-104D3 104D8-104FB "
        "10500-10527 10530-10563 10570-1057A 1057C-1058A 1058C-10592 10594-10595 10597-105A1 "
        "105A3-105B1 105B3-105B9 105BB-105BC 105C0-105F3 10600-10736 10740-10755 10760-10767 "
        "10780-10785 10787-107B0 107B2-107BA 10800-10805 10808 1080A-10835 10837-10838 1083C "
        "1083F-10855 10860-10876 10880-1089E 108E0-108F2 108F4-108F5 10900-10915 10920-10939 "
        "10940-10959 10980-109B7 109BE-109BF 10A00-10A03 10A05-10A06 10A0C-10A13 10A15-10A17 "
        "10A19-10A35 10A38-10A3A 10A3F 10A60-10A7C 10A80-10A9C 10AC0-10AC7 10AC9-10AE6 "
        "10B00-10B35 10B40-10B55 10B60-10B72 10B80-10B91 10C00-10C48 10C80-10CB2 10CC0-10CF2 "
        "10D00-10D27 10D30-10D39 10D40-10D65 10D69-10D6D 10D6F-10D85 10E80-10EA9 10EAB-10EAC "
        "10EB0-10EB1 10EC2-10EC7 10EFA-10F1C 10F27 10F30-10F50 10F70-10F85 10FB0-10FC4 "
        "10FE0-10FF6 11000-11046 11066-11075 1107F-110BA 110C2 110D0-110E8 110F0-110F9 "
        "11100-11134 11136-1113F 11144-11147 11150-11173 11176 11180-111C4 111C9-111CC "
        "111CE-111DA 111DC 11200-11211 11213-11237 1123E-11241 11280-11286 11288 1128A-1128D "
        "1128F-1129D 1129F-112A8 112B0-112EA 112F0-112F9 11300-11303 11305-1130C 1130F-11310 "
        "11313-11328 1132A-11330 11332-11333 11335-11339 1133B-11344 11347-11348 1134B-1134D "
        "11350 11357 1135D-11363 11366-1136C 11370-11374 11380-11389 1138B 1138E 11390-113B5 "
        "113B7-113C0 113C2 113C5 113C7-113CA 113CC-113D3 113E1-113E2 11400-1144A 11450-11459 "
        "1145E-11461 11480-114C5 114C7 114D0-114D9 11580-115B5 115B8-115C0 115D8-115DD "
        "11600-11640 11644 11650-11659 11680-116B8 116C0-116C9 116D0-116E3 11700-1171A "
        "1171D-1172B 11730-11739 11740-11746 11800-1183A 118A0-118E9 118FF-11906 11909 "
        "1190C-11913 11915-11916 11918-11935 11937-11938 1193B-11943 11950-11959 119A0-119A7 "
        "119AA-119D7 119DA-119E1 119E3-119E4 11A00-11A3E 11A47 11A50-11A99 11A9D 11AB0-11AF8 "
        "11B60-11B67 11BC0-11BE0 11BF0-11BF9 11C00-11C08 11C0A-11C36 11C38-11C40 11C50-11C59 "
        "11C72-11C8F 11C92-11CA7 11CA9-11CB6 11D00-11D06 11D08-11D09 11D0B-11D36 11D3A "
        "11D3C-11D3D 11D3F-11D47 11D50-11D59 11D60-11D65 11D67-11D68 11D6A-11D8E 11D90-11D91 "
        "11D93-11D98 11DA0-11DA9 11DB0-11DDB 11DE0-11DE9 11EE0-11EF6 11F00-11F10 11F12-11F3A "
        "11F3E-11F42 11F50-11F5A 11FB0 12000-12399 12400-1246E 12480-12543 12F90-12FF0 "
        "13000-1342F 13440-13455 13460-143FA 14400-14646 16100-16139 16800-16A38 16A40-16A5E "
        "16A60-16A69 16A70-16ABE 16AC0-16AC9 16AD0-16AED 16AF0-16AF4 16B00-16B36 16B40-16B43 "
        "16B50-16B59 16B63-16B77 16B7D-16B8F 16D40-16D6C 16D70-16D79 16E40-16E7F 16EA0-16EB8 "
        "16EBB-16ED3 16F00-16F4A 16F4F-16F87 16F8F-16F9F 16FE0-16FE1 16FE3-16FE4 16FF0-16FF6 "
        "17000-18CD5 18CFF-18D1E 18D80-18DF2 1AFF0-1AFF3 1AFF5-1AFFB 1AFFD-1AFFE 1B000-1B122 "
        "1B132 1B150-1B152 1B155 1B164-1B167 1B170-1B2FB 1BC00-1BC6A 1BC70-1BC7C 1BC80-1BC88 "
        "1BC90-1BC99 1BC9D-1BC9E 1CCF0-1CCF9 1CF00-1CF2D 1CF30-1CF46 1D165-1D169 1D16D-1D172 "
        "1D17B-1D182 1D185-1D18B 1D1AA-1D1AD 1D242-1D244 1D400-1D454 1D456-1D49C 1D49E-1D49F "
        "1D4A2 1D4A5-1D4A6 1D4A9-1D4AC 1D4AE-1D4B9 1D4BB 1D4BD-1D4C3 1D4C5-1D505 1D507-1D50A "
        "1D50D-1D514 1D516-1D51C 1D51E-1D539 1D53B-1D53E 1D540-1D544 1D546 1D54A-1D550 "
        "1D552-1D6A5 1D6A8-1D6C0 1D6C2-1D6DA 1D6DC-1D6FA 1D6FC-1D714 1D716-1D734 1D736-1D74E "
        "1D750-1D76E 1D770-1D788 1D78A-1D7A8 1D7AA-1D7C2 1D7C4-1D7CB 1D7CE-1D7FF 1DA00-1DA36 "
        "1DA3B-1DA6C 1DA75 1DA84 1DA9B-1DA9F 1DAA1-1DAAF 1DF00-1DF1E 1DF25-1DF2A 1E000-1E006 "
        "1E008-1E018 1E01B-1E021 1E023-1E024 1E026-1E02A 1E030-1E06D 1E08F 1E100-1E12C "
        "1E130-1E13D 1E140-1E149 1E14E 1E290-1E2AE 1E2C0-1E2F9 1E4D0-1E4F9 1E5D0-1E5FA "
        "1E6C0-1E6DE 1E6E0-1E6F5 1E6FE-1E6FF 1E7E0-1E7E6 1E7E8-1E7EB 1E7ED-1E7EE 1E7F0-1E7FE "
        "1E800-1E8C4 1E8D0-1E8D6 1E900-1E94B 1E950-1E959 1EE00-1EE03 1EE05-1EE1F 1EE21-1EE22 "
        "1EE24 1EE27 1EE29-1EE32 1EE34-1EE37 1EE39 1EE3B 1EE42 1EE47 1EE49 1EE4B 1EE4D-1EE4F "
        "1EE51-1EE52 1EE54 1EE57 1EE59 1EE5B 1EE5D 1EE5F 1EE61-1EE62 1EE64 1EE67-1EE6A "
        "1EE6C-1EE72 1EE74-1EE77 1EE79-1EE7C 1EE7E 1EE80-1EE89 1EE8B-1EE9B 1EEA1-1EEA3 "
        "1EEA5-1EEA9 1EEAB-1EEBB 1F130-1F149 1F150-1F169 1F170-1F189 1FBF0-1FBF9 20000-2A6DF "
        "2A700-2B81D 2B820-2CEAD 2CEB0-2EBE0 2EBF0-2EE5D 2F800-2FA1D 30000-3134A 31350-33479 "
        "E0100-E01EF "
    ),
}
