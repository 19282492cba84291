"""Host tree toolkit: newick parse/write and tree surgery (the port's copy
of the JAX package's ``tree/newick.py``).

In-repo replacement for the reference's treeswift usage
(main.py:27-28,190,203,418,430-436,444-500): parsing, writing, postorder
traversal, edge scaling, diameter, and leaf-subset extraction.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Node:
    label: str | None = None
    edge_length: float | None = None
    children: list["Node"] = field(default_factory=list)
    parent: "Node | None" = None

    def is_leaf(self) -> bool:
        return not self.children

    def traverse_postorder(self):
        stack: list[tuple[Node, bool]] = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                yield node
            else:
                stack.append((node, True))
                for c in reversed(node.children):
                    stack.append((c, False))

    def traverse_preorder(self):
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))


def _fmt_len(x: float) -> str:
    """Edge-length formatting: 12 significant digits, trailing zeros trimmed
    (matches the clean integers in the reference's scaled-tree outputs,
    toy_example train_tree_r100.0.nwk)."""
    s = f"{x:.12g}"
    return s


_NEEDS_QUOTE = set(" \t(),:;[]'")


def _quote_label(label: str) -> str:
    """Re-quote labels that contain newick structural characters or spaces
    (parse_newick accepts quoted labels; emitting them bare produced
    unparseable trees). Internal quotes double per the newick convention."""
    if any(c in _NEEDS_QUOTE for c in label):
        return "'" + label.replace("'", "''") + "'"
    return label


class Tree:
    def __init__(self, root: Node):
        self.root = root

    # -- traversal / queries --------------------------------------------------
    def traverse_postorder(self):
        return self.root.traverse_postorder()

    def traverse_preorder(self):
        return self.root.traverse_preorder()

    def leaves(self) -> list[Node]:
        return [n for n in self.traverse_postorder() if n.is_leaf()]

    def leaf_labels(self) -> list[str]:
        return [n.label for n in self.leaves()]

    def num_nodes(self, internal: bool = True) -> int:
        if internal:
            return sum(1 for _ in self.traverse_postorder())
        return sum(1 for n in self.traverse_postorder() if n.is_leaf())

    # -- mutation -------------------------------------------------------------
    def scale_edges(self, factor: float) -> None:
        for n in self.traverse_postorder():
            if n.edge_length is not None:
                n.edge_length = n.edge_length * factor

    def diameter(self) -> float:
        """Maximum leaf-to-leaf path length (edge lengths; None treated as 0)."""
        best = 0.0
        down: dict[int, float] = {}
        for n in self.traverse_postorder():
            if n.is_leaf():
                down[id(n)] = 0.0
            else:
                tops = sorted(
                    (down[id(c)] + (c.edge_length or 0.0) for c in n.children),
                    reverse=True,
                )
                down[id(n)] = tops[0]
                # only leaf-to-leaf paths count: a unary node contributes no
                # pair (a 1-leaf tree has diameter 0)
                if len(tops) > 1:
                    best = max(best, tops[0] + tops[1])
        return best

    def extract_tree_with(self, labels: set[str]) -> "Tree":
        """Copied subtree induced by the given leaf labels, with unifurcations
        suppressed (edge lengths summed), like treeswift's extract_tree_with
        used at main.py:497."""
        keep = set(labels)

        # iterative postorder build (recursion would overflow on deep
        # ladder-like phylogenies well below the 12000-taxon scale)
        built: dict[int, Node | None] = {}
        for node in self.traverse_postorder():
            if node.is_leaf():
                built[id(node)] = (
                    Node(node.label, node.edge_length) if node.label in keep else None
                )
                continue
            kids = [b for b in (built[id(c)] for c in node.children) if b is not None]
            if not kids:
                built[id(node)] = None
            elif len(kids) == 1:
                child = kids[0]
                # suppress unifurcation: fold this node's edge into the child
                if node.edge_length is not None or child.edge_length is not None:
                    child.edge_length = (node.edge_length or 0.0) + (child.edge_length or 0.0)
                built[id(node)] = child
            else:
                new = Node(node.label, node.edge_length, kids)
                for c2 in kids:
                    c2.parent = new
                built[id(node)] = new

        root = built[id(self.root)]
        if root is None:
            root = Node()
        # root edge length is conventionally dropped after extraction
        # (treeswift convention; it sits on no leaf-leaf path)
        root.edge_length = None
        root.parent = None
        return Tree(root)

    # -- serialization --------------------------------------------------------
    def write_newick(self) -> str:
        # explicit-stack emission: deep trees must not hit the recursion limit
        parts: list[str] = []
        stack: list[tuple[Node, int]] = [(self.root, 0)]
        while stack:
            node, i = stack.pop()
            if node.children:
                if i == 0:
                    parts.append("(")
                if i < len(node.children):
                    if i:
                        parts.append(",")
                    stack.append((node, i + 1))
                    stack.append((node.children[i], 0))
                    continue
                parts.append(")")
            if node.label is not None:
                parts.append(_quote_label(node.label))
            if node.edge_length is not None:
                parts.append(":" + _fmt_len(node.edge_length))
        parts.append(";")
        return "".join(parts)

    def write_tree_newick(self, path: str) -> None:
        # no trailing newline: byte parity with the reference's checked-in
        # scaled trees (toy_example train_tree_r100.0.nwk)
        with open(path, "w") as f:
            f.write(self.write_newick())


def parse_newick(text: str) -> Tree:
    """Parse a newick string (labels, branch lengths, quoted labels,
    [comments] skipped)."""
    s = text.strip()
    if s.endswith(";"):
        s = s[:-1]
    pos = 0
    n = len(s)

    def skip_ws() -> None:
        nonlocal pos
        while pos < n and (s[pos].isspace() or s[pos] == "["):
            if s[pos] == "[":  # comment
                end = s.find("]", pos)
                pos = n if end < 0 else end + 1
            else:
                pos += 1

    def parse_label() -> str | None:
        nonlocal pos
        skip_ws()
        if pos < n and s[pos] in "'\"":
            q = s[pos]
            pos += 1
            chars: list[str] = []
            while pos < n:
                if s[pos] == q:
                    # doubled quote = escaped literal quote (newick convention)
                    if pos + 1 < n and s[pos + 1] == q:
                        chars.append(q)
                        pos += 2
                        continue
                    break
                chars.append(s[pos])
                pos += 1
            pos += 1
            return "".join(chars)
        start = pos
        while pos < n and s[pos] not in ",():;[":
            pos += 1
        label = s[start:pos].strip()
        return label or None

    def parse_length() -> float | None:
        nonlocal pos
        skip_ws()
        if pos < n and s[pos] == ":":
            pos += 1
            skip_ws()
            start = pos
            while pos < n and s[pos] not in ",()[;":
                pos += 1
            return float(s[start:pos].strip())
        return None

    # iterative shift-reduce parse: recursion would overflow on deep
    # (pectinate) trees far below the 12000-taxon scale this supports
    root = Node()
    cur = root
    stack: list[Node] = []
    while True:
        skip_ws()
        if pos >= n:
            break
        ch = s[pos]
        if ch == "(":
            pos += 1
            stack.append(cur)
            child = Node()
            child.parent = cur
            cur.children.append(child)
            cur = child
        elif ch == ",":
            pos += 1
            if not stack:
                raise ValueError(f"unexpected ',' outside parentheses at {pos}")
            parent = stack[-1]
            sib = Node()
            sib.parent = parent
            parent.children.append(sib)
            cur = sib
        elif ch == ")":
            pos += 1
            if not stack:
                raise ValueError(f"unbalanced parentheses in newick at {pos}")
            cur = stack.pop()
            cur.label = parse_label()
            cur.edge_length = parse_length()
        elif ch == ";":
            # first tree ends here; ignore any trailing content (second trees,
            # stray text) like the recursive parsers in treeswift do
            break
        else:
            before = pos
            cur.label = parse_label()
            cur.edge_length = parse_length()
            if pos == before:
                raise ValueError(f"unparseable newick content at position {pos}")
    if stack:
        raise ValueError("unbalanced parentheses in newick (unclosed '(')")
    return Tree(root)


def read_tree_newick(path: str) -> Tree:
    with open(path) as f:
        return parse_newick(f.read())
