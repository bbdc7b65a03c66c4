"""Graph and matrix visualization helpers (the JAX package's
``gviz.py``): graphviz node/edge drawings, PIL raster heatmaps, and
notebook exports.  They read a container's host triples only, so they
need no device.  The optional dependencies (graphviz, matplotlib, PIL,
pyvis) are imported lazily through `_require`.
"""

__all__ = [
    "draw",
    "draw_graph",
    "draw_matrix",
    "draw_vector",
    "draw_vector_dot",
    "draw_matrix_op",
    "draw_layers",
    "draw_matrix_layers",
    "draw_graph_op",
    "draw_cy",
    "draw_vis",
]


def _require(modname):
    import importlib

    try:
        return importlib.import_module(modname)
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            f"{modname} is required for this visualization helper") from e


def draw_graph(M, name="", rankdir="LR", show_weight=True, concentrate=True,
               label_vector=None, label_width=None, label_cmap=None,
               size_vector=None, size_scale=1.0, min_size=0.1,
               log_scale=False, filename=None, directed=True, B=None,
               ioff=0, joff=0, weight_prefix="", edge_cmap=None,
               graph_attr=None, node_attr=None, edge_attr=None):
    """Draw a Matrix as a graphviz node/edge graph.

    With `B` given, draw the bipartite/incidence form (hypergraph mode,
    reference gviz.py:118-123).  Option surface per the reference
    ``gviz.py:66-123``: `edge_cmap`/`label_cmap` color edges by weight /
    nodes by label value; `size_vector` scales node widths by
    `size_scale` with a `min_size` floor, optionally on a `log_scale`;
    `weight_prefix` prefixes edge labels; `ioff`/`joff` offset node ids.

    >>> from pygraphblas_tpu_torch import Matrix
    >>> M = Matrix.from_lists([0, 1], [1, 0], [1, 2])
    >>> g = draw_graph(M)
    >>> 'digraph' in g.source
    True
    >>> g2 = draw_graph(M, edge_cmap="viridis", size_vector={0: 2, 1: 3},
    ...                 log_scale=True, weight_prefix="w=")
    >>> 'w=' in g2.source
    True
    """
    gv = _require("graphviz")
    cls = gv.Digraph if directed else gv.Graph
    g = cls(name, graph_attr=graph_attr or {}, node_attr=node_attr or {},
            edge_attr=edge_attr or {})
    g.attr(rankdir=rankdir)
    if concentrate:
        g.attr(concentrate="true")

    if edge_cmap is not None or label_cmap is not None:
        plt = _require("matplotlib.pyplot")
        colors = _require("matplotlib.colors")
        if edge_cmap is not None:
            edge_cmap = plt.get_cmap(edge_cmap)
        if label_cmap is not None:
            label_cmap = plt.get_cmap(label_cmap)
        rgb2hex = colors.rgb2hex
    else:
        rgb2hex = None

    def _lbl_val(i):
        if label_vector is None:
            return None
        try:
            return label_vector.get(i)
        except AttributeError:   # plain list / ndarray
            return label_vector[i] if i < len(label_vector) else None

    def node_label(i):
        lbl = _lbl_val(i)
        if lbl is not None:
            s = str(lbl)
            return s[:label_width] if label_width else s
        return str(i)

    def node_size(i):
        if size_vector is None:
            return None
        try:
            s = size_vector.get(i)
        except AttributeError:
            s = size_vector[i] if i < len(size_vector) else None
        if s is None:
            return None
        from math import log

        sz = max(float(s) * size_scale, min_size)
        if log_scale:
            sz = max(log(sz), min_size)
        return str(sz)

    seen = set()

    def add_node(i, off=0):
        if (i, off) in seen:
            return
        seen.add((i, off))
        attrs = {}
        sz = node_size(i)
        if sz:
            attrs["width"] = sz
            attrs["fixedsize"] = "true"
        if label_cmap is not None:
            lv = _lbl_val(i)
            if lv is not None:
                attrs["color"] = rgb2hex(label_cmap(float(lv)))
        g.node(str(i + off), node_label(i), **attrs)

    def edge_args(v):
        attrs = {}
        if edge_cmap is not None:
            attrs["color"] = rgb2hex(edge_cmap(float(v)))
        label = f"{weight_prefix}{v}" if show_weight else None
        return label, attrs

    if B is not None:
        # incidence / hypergraph drawing: M maps nodes->edges, B edges->nodes
        for i, j, v in M:
            add_node(i, ioff)
            g.node(f"e{j}", shape="point")
            label, attrs = edge_args(v)
            g.edge(str(i + ioff), f"e{j}", label=label, **attrs)
        for i, j, v in B:
            label, attrs = edge_args(v)
            g.edge(f"e{i}", str(j + joff), label=label, **attrs)
    else:
        for i, j, v in M:
            add_node(i, ioff)
            add_node(j, joff)
            label, attrs = edge_args(v)
            g.edge(str(i + ioff), str(j + joff), label=label, **attrs)

    if filename is not None:
        g.render(filename, format="png", cleanup=True)
    return g


def draw_vector_dot(V, name="", rankdir="LR", ioff=0, joff=0):
    """Draw a Vector as a graphviz chain of ``index:value`` nodes
    (reference gviz.py:58-63).

    >>> from pygraphblas_tpu_torch import Vector
    >>> g = draw_vector_dot(Vector.from_lists([0, 2], [7, 9]))
    >>> '0:7' in g.source and '2:9' in g.source
    True
    """
    gv = _require("graphviz")
    g = gv.Digraph(name)
    g.attr(rankdir=rankdir, ranksep="1")
    for i, v in V:
        g.node(str(i + ioff), label="%s:%s" % (str(i), str(v)))
    return g


def draw(obj, name="", **kws):
    """Dispatch: Matrices draw as graphs, Vectors as dot chains
    (reference gviz.py:241-247).

    >>> from pygraphblas_tpu_torch import Matrix, Vector
    >>> 'digraph' in draw(Matrix.from_lists([0], [1], [2])).source
    True
    >>> '0:7' in draw(Vector.from_lists([0], [7])).source
    True
    """
    from .matrix import Matrix
    from .vector import Vector

    if isinstance(obj, Matrix):
        return draw_graph(obj, name, **kws)
    if isinstance(obj, Vector):
        return draw_vector_dot(obj, name, **kws)
    raise TypeError("draw() takes a Matrix or a Vector")


def draw_graph_op(left, op, right, result, **kwargs):  # pragma: no cover
    """Draw `left op right = result` as graphs side by side
    (reference gviz.py:251-275): operands offset into disjoint id
    ranges so the three subgraphs don't share nodes."""
    gv = _require("graphviz")
    from .matrix import Matrix

    g = gv.Digraph()
    ioff = joff = 0

    def _sub(obj, name):
        nonlocal ioff, joff
        if isinstance(obj, Matrix):
            ioff += obj.nrows
            joff += obj.ncols
            return draw_graph(obj, name=name, ioff=ioff, joff=joff)
        ioff += obj.size
        joff += obj.size
        return draw_vector_dot(obj, name=name, ioff=ioff, joff=joff)

    g.subgraph(_sub(left, "cluster_left"))
    g.node(op, width="0.5")
    g.subgraph(_sub(right, "cluster_right"))
    g.node("=", width="0.5")
    g.subgraph(_sub(result, "cluster_result"))
    return g


def _val_to_color(val, vmin, vmax, cmap=None):
    if cmap is not None:
        import matplotlib.cm
        import matplotlib.colors

        norm = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)
        mapper = matplotlib.cm.ScalarMappable(norm=norm, cmap=cmap)
        r, g, b, _ = mapper.to_rgba(val)
        return (int(r * 255), int(g * 255), int(b * 255))
    span = (vmax - vmin) or 1.0
    level = int(255 * (float(val) - vmin) / span)
    return (level, level, level)


def draw_matrix(M, scale=10, axes=True, cmap="viridis", filename=None,
                mode="RGB", background=(255, 255, 255)):
    """Draw a Matrix as a PIL raster heatmap (one cell per element).

    >>> from pygraphblas_tpu_torch import Matrix
    >>> M = Matrix.from_lists([0, 1], [1, 0], [1, 2])
    >>> img = draw_matrix(M, scale=4)
    >>> img.size
    (12, 12)
    """
    pil = _require("PIL.Image")
    w = (M.ncols + 1) * scale
    h = (M.nrows + 1) * scale
    img = pil.new(mode, (w, h), background)
    try:
        vmin = float(min(M.V)) if M.nvals else 0.0
        vmax = float(max(M.V)) if M.nvals else 1.0
    except TypeError:
        vmin, vmax = 0.0, 1.0
    px = img.load()
    for i, j, v in M:
        color = _val_to_color(float(v), vmin, vmax, cmap)
        for dy in range(scale):
            for dx in range(scale):
                x = (j + 1) * scale + dx
                y = (i + 1) * scale + dy
                if x < w and y < h:
                    px[x, y] = color
    if axes:
        for k in range(w):
            px[k, scale - 1] = (0, 0, 0)
        for k in range(h):
            px[scale - 1, k] = (0, 0, 0)
    if filename is not None:  # pragma: no cover
        img.save(str(filename) + ".png")
    return img


def draw_vector(V, scale=10, cmap="viridis", filename=None):
    """Draw a Vector as a 1-column heatmap.

    >>> from pygraphblas_tpu_torch import Vector
    >>> img = draw_vector(Vector.from_list([1, 2, 3]), scale=4)
    >>> img.size[1]
    16
    """
    from .matrix import Matrix

    m = Matrix.sparse(V.type, V.size, 1)
    for i, v in V:
        m[i, 0] = v
    return draw_matrix(m, scale=scale, cmap=cmap, filename=filename)


def draw_matrix_op(left, op, right, result, scale=10, cmap="viridis",
                   filename=None):  # pragma: no cover
    """Draw `left op right = result` as heatmap images side by side."""
    pil = _require("PIL.Image")
    draw_font = _require("PIL.ImageDraw")
    imgs = [draw_matrix(left, scale=scale, cmap=cmap),
            draw_matrix(right, scale=scale, cmap=cmap),
            draw_matrix(result, scale=scale, cmap=cmap)]
    gap = scale * 3
    w = sum(i.size[0] for i in imgs) + 2 * gap
    h = max(i.size[1] for i in imgs)
    out = pil.new("RGB", (w, h), (255, 255, 255))
    x = 0
    labels = [op, "="]
    d = draw_font.Draw(out)
    for k, img in enumerate(imgs):
        out.paste(img, (x, 0))
        x += img.size[0]
        if k < 2:
            d.text((x + scale, h // 2), labels[k], fill=(0, 0, 0))
            x += gap
    if filename is not None:
        out.save(str(filename) + ".png")
    return out


def draw_layers(M, name="", rankdir="LR", label_width=None):
    """Draw a multi-layer (DNN) stack of matrices as a graphviz layered
    node graph: layer l's rows are one rank, edges follow the nonzero
    pattern into layer l+1 (reference gviz.py:205-239).

    >>> from pygraphblas_tpu_torch import Matrix
    >>> W = Matrix.from_lists([0, 1], [1, 0], [1, 1], 2, 2)
    >>> g = draw_layers([W, W])
    >>> g.source.count('invis') > 0
    True
    """
    gv = _require("graphviz")
    g = gv.Digraph(name)
    g.attr(rankdir=rankdir, ranksep="1")

    def _s(x):
        return str(x)[:label_width] if label_width else str(x)

    for l, m in enumerate(M):
        with g.subgraph() as s:
            s.attr(rank="same", rankdir="TB")
            for i in range(m.nrows):
                si = (l * m.nrows) + i
                s.node(str(si), label=_s(si), width="0.5")
                if i < m.nrows - 1:
                    s.edge(str(si), str(si + 1), style="invis",
                           minlen="0", weight="1000")
    last = M[-1]
    with g.subgraph() as s:
        s.attr(rank="same", rankdir="LR")
        for j in range(last.nrows):
            sj = (len(M) * last.nrows) + j
            s.node(str(sj), label=_s(j), width="0.5")
            if j < last.nrows - 1:
                s.edge(str(sj), str(sj + 1), style="invis")
    for l, m in enumerate(M):
        for i, j, _ in m:
            g.edge(str((l * m.nrows) + i), str(((l + 1) * m.nrows) + j))
    return g


def draw_matrix_layers(layers, scale=10, cmap="viridis",
                       filename=None):  # pragma: no cover
    """Draw a multi-layer (DNN) stack of matrices as a heatmap strip
    (reference gviz.py:432-443)."""
    pil = _require("PIL.Image")
    imgs = [draw_matrix(m, scale=scale, cmap=cmap) for m in layers]
    gap = scale * 2
    w = sum(i.size[0] for i in imgs) + gap * (len(imgs) - 1)
    h = max(i.size[1] for i in imgs)
    out = pil.new("RGB", (w, h), (255, 255, 255))
    x = 0
    for img in imgs:
        out.paste(img, (x, 0))
        x += img.size[0] + gap
    if filename is not None:
        out.save(str(filename) + ".png")
    return out


def draw_cy(M, name="graph"):  # pragma: no cover
    """Export to a Cytoscape-widget-compatible dict."""
    nodes = set()
    edges = []
    for i, j, v in M:
        nodes.add(i)
        nodes.add(j)
        edges.append({"data": {"source": str(i), "target": str(j),
                               "weight": float(v)}})
    return {
        "elements": {
            "nodes": [{"data": {"id": str(n)}} for n in sorted(nodes)],
            "edges": edges,
        },
        "name": name,
    }


def draw_vis(M, notebook=True, **kwargs):  # pragma: no cover
    """Export to a pyvis Network (requires the optional pyvis package)."""
    pyvis = _require("pyvis.network")
    net = pyvis.Network(notebook=notebook, **kwargs)
    for i, j, v in M:
        net.add_node(int(i))
        net.add_node(int(j))
        net.add_edge(int(i), int(j), value=float(v))
    return net
