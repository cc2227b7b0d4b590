"""igmc_torch.train.visualize against the JAX package's visualize on the
CPU, on tests/test_models.py's fixture (a 30 x 30 rating matrix from
default_rng(0), 20 one-hop graphs, IGMCConfig(num_relations=5,
num_bases=4) from PRNGKey(0), the weights moved with params_from_jax):
the predictions, the graphs chosen and the panel titles for each sort_by;
the drawing maths against the libraries they replace (networkx's
bipartite_layout and Graph, matplotlib's rainbow colormap and named
colours); and the PDF's structure. JAX's choices are recorded by wrapping
subgraph_to_nx and Axes.set_title in the test, the port's by wrapping
subgraph_edges and reading the PDF's text."""

import re
import zlib

import matplotlib
import matplotlib.axes
import networkx as nx
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

from igmc_tpu.batching.dataset import BatchLoader as JaxBatchLoader
from igmc_tpu.graphs import BipartiteCSR as JaxBipartiteCSR
from igmc_tpu.graphs import extract_many as jax_extract_many
from igmc_tpu.models import IGMCConfig as JaxIGMCConfig
from igmc_tpu.models import igmc_forward, igmc_init
from igmc_tpu.train import visualize as jax_vis
from igmc_tpu.train.loop import make_eval_step as jax_make_eval_step
from igmc_tpu.train.loop import predict_all as jax_predict_all

from igmc_torch.graphs import BipartiteCSR, extract_many
from igmc_torch.models import IGMC, IGMCConfig
from igmc_torch.train import params_from_jax
from igmc_torch.train import visualize as port_vis
from igmc_torch.utils.pdf import Page, check_pdf, text_width

torch.set_num_threads(1)

PRED_ATOL = 1e-5
LAYOUT_ATOL = 1e-12
COLOR_ATOL = 1e-6
NUM = 5


class DS:
    """test_models.py's dataset: a list of extracted subgraphs."""

    def __init__(self, graphs):
        self.graphs = graphs

    def __len__(self):
        return len(self.graphs)

    def get(self, i):
        return self.graphs[i]

    def node_counts(self):
        return np.array([g.num_nodes for g in self.graphs])

    def edge_counts(self):
        return np.array([g.num_edges for g in self.graphs])


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    M = (rng.random((30, 30)) < 0.4).astype(np.float32) * rng.integers(
        1, 6, (30, 30)).astype(np.float32)
    us, vs = np.nonzero(M)
    labels = (M[us, vs] - 1).astype(np.int64)
    cv = np.arange(1.0, 6.0)
    jax_graphs = jax_extract_many((us[:20], vs[:20]), labels[:20],
                                  JaxBipartiteCSR(sp.csr_matrix(M)), h=1,
                                  class_values=cv, backend="numpy")
    port_graphs = extract_many((us[:20], vs[:20]), labels[:20],
                               BipartiteCSR(sp.csr_matrix(M)), h=1,
                               class_values=cv, backend="numpy")
    for a, b in zip(jax_graphs, port_graphs):
        for k in ("src", "dst", "etype", "node_label"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    cfg = JaxIGMCConfig(num_relations=5, num_bases=4)
    params = igmc_init(jax.random.PRNGKey(0), cfg)
    fwd = lambda p, b, key=None, training=False: igmc_forward(p, b, cfg, key, training)
    model = IGMC(IGMCConfig(num_relations=5, num_bases=4),
                 torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return dict(cv=cv, jax_ds=DS(jax_graphs), port_ds=DS(port_graphs), fwd=fwd,
                params=params, model=model)


def _titles(content: str) -> list:
    """The text of every panel title in a content stream (size 20)."""
    return [m.group(1).replace("\\(", "(").replace("\\)", ")")
            for m in re.finditer(r"/F1 20 Tf \S+ \S+ Td \((.*)\) Tj ET", content)]


def _run_jax(case, sort_by, tmp_path, monkeypatch):
    """JAX's visualize: (chosen graph indices, titles)."""
    drawn, titles = [], []
    index = {id(g): i for i, g in enumerate(case["jax_ds"].graphs)}
    to_nx = jax_vis.subgraph_to_nx
    set_title = matplotlib.axes.Axes.set_title
    monkeypatch.setattr(jax_vis, "subgraph_to_nx",
                        lambda g: drawn.append(index[id(g)]) or to_nx(g))
    monkeypatch.setattr(matplotlib.axes.Axes, "set_title",
                        lambda ax, label, *a, **k: titles.append(label)
                        or set_title(ax, label, *a, **k))
    np.random.seed(7)
    jax_vis.visualize(case["fwd"], case["params"], case["jax_ds"], str(tmp_path),
                      "unittest", case["cv"], batch_size=10, sort_by=sort_by)
    monkeypatch.undo()
    return drawn, titles


def _run_port(case, sort_by, tmp_path, monkeypatch):
    """The port's visualize: (chosen graph indices, titles, PDF path)."""
    drawn = []
    index = {id(g): i for i, g in enumerate(case["port_ds"].graphs)}
    edges = port_vis.subgraph_edges
    monkeypatch.setattr(port_vis, "subgraph_edges",
                        lambda g: drawn.append(index[id(g)]) or edges(g))
    np.random.seed(7)
    path = port_vis.visualize(case["model"], case["port_ds"], str(tmp_path),
                              "unittest", case["cv"], batch_size=10,
                              sort_by=sort_by, device="cpu")
    monkeypatch.undo()
    return drawn, _titles(check_pdf(path)), path


def test_predictions_match_jax_and_are_tie_free(case):
    """The port's flat segment predictions equal JAX's predict_all (atol
    1e-5), targets exactly; neighbouring sorted predictions lie more than
    1e-5 apart, so both rank them in the same order."""
    R, Y = jax_predict_all(jax_make_eval_step(case["fwd"]), case["params"],
                           JaxBatchLoader(case["jax_ds"], 10, shuffle=False))
    preds, ys = port_vis.predict(case["model"], case["port_ds"], 10, device="cpu")
    assert preds.dtype == np.float32 and preds.shape == (20,)
    np.testing.assert_allclose(preds, np.asarray(R), rtol=0, atol=PRED_ATOL)
    np.testing.assert_array_equal(ys, np.asarray(Y))
    assert np.diff(np.sort(np.asarray(R))).min() > PRED_ATOL


@pytest.mark.parametrize("sort_by", ["prediction", "true", "random"])
def test_chosen_graphs_and_titles_equal_jax(case, sort_by, tmp_path, monkeypatch):
    """For each sort_by (random with np.random.seed fixed) the port draws the
    same 2 x 5 graphs in the same panels with the same titles as JAX, into
    visualization_<data>_<sort_by>.pdf."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_drawn, jax_titles = _run_jax(case, sort_by, tmp_path / "jax", monkeypatch)
    drawn, titles, path = _run_port(case, sort_by, tmp_path / "port", monkeypatch)
    assert len(jax_drawn) == 2 * NUM and len(jax_titles) == 2 * NUM
    assert drawn == jax_drawn
    assert titles == jax_titles
    assert path.endswith(f"visualization_unittest_{sort_by}.pdf")


def _layout_cases(case):
    for g in case["jax_ds"].graphs:
        G = jax_vis.subgraph_to_nx(g)
        yield G, [n for n, d in G.nodes(data=True) if d["type"] % 2 == 0]
    # node sets whose set order is not sorted order, single-node columns
    for n, top in ((40, [33, 0, 8, 17, 16, 1]), (2, [0]), (9, [0, 1, 2, 3, 4, 5, 6, 7]),
                   (70, list(range(0, 70, 3)))):
        G = nx.Graph()
        G.add_nodes_from(range(n))
        yield G, top


def test_bipartite_layout_equals_networkx(case):
    """bipartite_layout(n, top) equals networkx.bipartite_layout(G, top)
    to 1e-12 on the fixture's graphs and on node sets whose Python set
    order differs from sorted order."""
    for G, top in _layout_cases(case):
        want = nx.bipartite_layout(G, top)
        got = port_vis.bipartite_layout(G.number_of_nodes(), top)
        for node, xy in want.items():
            np.testing.assert_allclose(got[node], xy, rtol=0, atol=LAYOUT_ATOL)


@pytest.mark.parametrize("R", [5, 10, 71])
def test_rainbow_and_node_colors_equal_matplotlib(R):
    """rainbow() equals matplotlib's rainbow colormap (1e-6) on the
    normalised class values of R = 5 (1..5), 10 (0.5..5) and 71 (a yahoo-like
    set of 71 levels in 1..100), and on 1,001 points of [0, 1] and outside
    it; node_color equals matplotlib's named colours for every type."""
    cmap = matplotlib.colormaps["rainbow"]
    cv = {5: np.arange(1.0, 6.0), 10: np.arange(0.5, 5.01, 0.5),
          71: np.sort(np.random.default_rng(71).choice(np.arange(1.0, 101.0), 71,
                                                       replace=False))}[R]
    x = (cv - cv.min()) / (cv.max() - cv.min())
    np.testing.assert_allclose(port_vis.rainbow(x), cmap(x)[:, :3], rtol=0,
                               atol=COLOR_ATOL)
    x = np.concatenate([np.linspace(0, 1, 1001), [-0.5, 1.5]])
    np.testing.assert_allclose(port_vis.rainbow(x), cmap(x)[:, :3], rtol=0,
                               atol=COLOR_ATOL)
    names = ["xkcd:red", "xkcd:blue", "xkcd:orange", "xkcd:lightblue", "y", "g"]
    for t in range(2 * R):
        want = matplotlib.colors.to_rgb(names[t % 6])
        np.testing.assert_allclose(port_vis.node_color(t), want, atol=COLOR_ATOL)
    np.testing.assert_allclose(port_vis.GRAY, matplotlib.colors.to_rgb("gray"),
                               atol=COLOR_ATOL)


def test_subgraph_edges_equal_networkx(case):
    """subgraph_edges gives networkx's undirected edge set with each edge's
    last relation (nx.Graph.add_edge) and the node types, on the fixture's
    graphs and on a graph that repeats a pair with another relation."""
    graphs = list(zip(case["jax_ds"].graphs, case["port_ds"].graphs))
    g = case["port_ds"].graphs[0]
    rep = type(g)(src=np.concatenate([g.src, g.src[:2]]),
                  dst=np.concatenate([g.dst, g.dst[:2]]),
                  etype=np.concatenate([g.etype, (g.etype[:2] + 1) % 5]),
                  node_label=g.node_label, num_u=g.num_u, num_v=g.num_v, y=g.y)
    graphs.append((rep, rep))
    for jg, pg in graphs:
        G = jax_vis.subgraph_to_nx(jg)
        edges, node_label = port_vis.subgraph_edges(pg)
        assert {(a, b, t) for (a, b), t in edges.items()} == set(G.edges(data="type"))
        assert node_label.tolist() == [d["type"] for _, d in G.nodes(data=True)]


def test_pdf_structure(case, tmp_path):
    """The PDF starts with %PDF- and ends with %%EOF, startxref points at
    the xref table and every xref offset at its `n 0 obj`; the inflated
    content holds the 10 titles, one disc per node plus the redrawn
    targets, and one segment per undirected edge (the colour bar draws
    rectangles only)."""
    preds, ys = port_vis.predict(case["model"], case["port_ds"], 10, device="cpu")
    path = port_vis.visualize(case["model"], case["port_ds"], str(tmp_path), "unittest",
                              case["cv"], batch_size=10, device="cpu")
    data = open(path, "rb").read()
    assert data.startswith(b"%PDF-") and data.rstrip().endswith(b"%%EOF")
    xref = int(re.search(rb"startxref\s+(\d+)\s+%%EOF\s*$", data).group(1))
    assert data[xref:].startswith(b"xref")
    rows = data[xref:].split(b"\n")
    count = int(rows[1].split()[1])
    for n, row in enumerate(rows[2:2 + count]):
        offset, _, kind = row.split()
        if kind == b"n":
            assert data[int(offset):].startswith(b"%d 0 obj" % n)
    length = int(re.search(rb"/Length (\d+)", data).group(1))
    start = data.index(b"stream\n") + len(b"stream\n")
    content = zlib.decompress(data[start:start + length]).decode("latin-1")
    assert content == check_pdf(path)

    idx = port_vis.choose(preds, ys, NUM, "prediction")
    assert _titles(content) == ["{:.4f} ({:})".format(preds[i], ys[i]) for i in idx]
    lines = content.splitlines()
    graphs = [case["port_ds"].get(i) for i in idx]
    u_counts = [int((g.node_label % 2 == 0).sum()) for g in graphs]
    discs = sum(g.num_nodes + 1 + (u < g.num_nodes) for g, u in zip(graphs, u_counts))
    assert sum(l.endswith(" c f") for l in lines) == discs
    segments = sum(len({(min(s, d), max(s, d)) for s, d in zip(g.src, g.dst)})
                   for g in graphs)
    assert sum(l.endswith(" l S") for l in lines) == segments
    assert "/MediaBox [0 0 1440 720]" in data.decode("latin-1")


def test_pdf_writer_text_and_plain_streams(tmp_path):
    """Text with (, ) and \\ is escaped and centred by Helvetica's widths;
    a plain (not deflated) stream holds the same content as a deflated
    one, and both pass check_pdf."""
    page = Page(200, 100)
    page.line(0, 0, 10, 10, (1, 0, 0))
    page.disc(50, 50, 5, (0, 0, 1))
    page.text(100, 20, "a (b) \\c", 10, anchor="center")
    page.rect(1, 2, 3, 4, (0, 1, 0), fill=False)
    page.save(str(tmp_path / "z.pdf"))
    page.save(str(tmp_path / "p.pdf"), compress=False)
    content = check_pdf(str(tmp_path / "z.pdf"))
    assert content == check_pdf(str(tmp_path / "p.pdf"))
    assert "(a \\(b\\) \\\\c) Tj" in content
    x = float(re.search(r"Tf (\S+) 20 Td", content).group(1))
    assert abs(x - (100 - text_width("a (b) \\c", 10) / 2)) < 1e-3
    assert text_width("0123456789", 1000) == 5560
    assert content.splitlines()[1].endswith(" c f") and content.count(" c ") == 4
