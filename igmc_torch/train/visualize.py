"""Qualitative visualization: draw the best- and worst-predicted enclosing
subgraphs into one vector PDF, without a plotting library.

Port of igmc_tpu/train/visualize.py: predict over the test graphs (the flat
segment engine, as the JAX package's evaluation loader plans no kernel
batch), rank by prediction, true rating or at random, and draw the top
`num` and bottom `num` subgraphs as bipartite layouts (users left, items
right), nodes coloured by hop/side label with the target user and item
drawn again on top, edges coloured by rating on the rainbow colormap, a
colour bar on the right, each panel titled "<prediction> (<rating>)". The
page is the JAX figure's 20 x 10 in (1440 x 720 pt), written to
<res_dir>/visualization_<data>_<sort_by>.pdf by utils/pdf.py.

The drawing maths are small pure functions, each the counterpart of the
library call it replaces: `subgraph_edges` (networkx.Graph as
subgraph_to_nx builds it), `bipartite_layout` (networkx 3.x
bipartite_layout with its defaults), `rainbow` (matplotlib's "rainbow"
colormap) and `node_color` (matplotlib's named colours).
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np

from ..batching.dataset import BatchLoader
from ..device import resolve_device
from ..utils.pdf import Page

PAGE_W, PAGE_H = 1440.0, 720.0            # 20 x 10 in
# matplotlib's subplot parameters after subplots_adjust(right=0.85)
GRID = dict(left=0.125, right=0.85, bottom=0.11, top=0.88, wspace=0.2, hspace=0.2)
COLORBAR = (0.88, 0.15, 0.02, 0.7)       # add_axes rectangle, figure fractions
NODE_RADIUS = math.sqrt(150.0) / 2.0     # node_size 150 pt^2 -> diameter sqrt(150)
TITLE_SIZE, TICK_SIZE = 20.0, 22.0

# matplotlib.colors.to_rgb of xkcd:red, xkcd:blue, xkcd:orange,
# xkcd:lightblue, y and g (node type % 6), and gray for any other type
TYPE_COLORS = {0: (0xe5 / 255, 0.0, 0.0), 1: (0x03 / 255, 0x43 / 255, 0xdf / 255),
               2: (0xf9 / 255, 0x73 / 255, 0x06 / 255),
               3: (0x7b / 255, 0xc8 / 255, 0xf6 / 255),
               4: (0.75, 0.75, 0.0), 5: (0.0, 0.5, 0.0)}
GRAY = (0x80 / 255,) * 3


def node_color(node_type: int):
    """RGB of a node of hop/side label `node_type`."""
    return TYPE_COLORS.get(int(node_type) % 6, GRAY)


def subgraph_edges(g):
    """(edges, node_label): the undirected edges of Subgraph `g` as a dict
    {(a, b): relation} with a < b, one entry per unordered pair holding the
    relation of its last occurrence (as nx.Graph.add_edge keeps it), in
    order of first occurrence; and each node's type."""
    edges = {}
    for s, d, t in zip(g.src.tolist(), g.dst.tolist(), g.etype.tolist()):
        edges[(min(s, d), max(s, d))] = int(t)
    return edges, np.asarray(g.node_label, dtype=np.int64)


def bipartite_layout(n_nodes: int, top) -> np.ndarray:
    """[n_nodes, 2] positions of nodes 0..n_nodes-1 as networkx's
    bipartite_layout(G, top) places them (align vertical, scale 1, aspect
    ratio 4/3, centre 0): `top` in a left column and the rest in a right
    one, each spread evenly over [0, 1] in networkx's order of its node
    sets, offset by (2/3, 1/2), centred on the mean and scaled so the
    largest |coordinate| is 1."""
    height, width = 1.0, 4.0 / 3.0
    top_set = set(top)
    bottom_set = set(range(n_nodes)) - top_set
    order = list(top_set) + list(bottom_set)
    left = np.column_stack([np.repeat(0, len(top_set)),
                            np.linspace(0, height, len(top_set))])
    right = np.column_stack([np.repeat(width, len(bottom_set)),
                             np.linspace(0, height, len(bottom_set))])
    pos = np.concatenate([left - (width / 2, height / 2),
                          right - (width / 2, height / 2)])
    pos -= pos.mean(axis=0)
    lim = np.abs(pos).max() if len(pos) else 0.0
    if lim > 0:
        pos *= 1.0 / lim
    out = np.zeros((n_nodes, 2))
    out[order] = pos
    return out


def _rainbow_lut() -> np.ndarray:
    """matplotlib's 256-entry rainbow LUT: red |2x - 0.5|, green sin(pi x),
    blue cos(pi x / 2) at linspace(0, 1, 256), clipped to [0, 1]."""
    x = np.linspace(0, 1, 256)
    return np.clip(np.stack([np.abs(2 * x - 0.5), np.sin(x * np.pi),
                             np.cos(x * np.pi / 2)], axis=1), 0, 1)


RAINBOW = _rainbow_lut()


def rainbow(x) -> np.ndarray:
    """RGB of the rainbow colormap at x in [0, 1] (scalar or array), indexed
    as matplotlib indexes a 256-entry map: min(int(x * 256), 255), clipped
    below at 0."""
    idx = np.clip((np.asarray(x, dtype=np.float64) * 256).astype(np.int64), 0, 255)
    return RAINBOW[idx]


def _normalize(v, vmin: float, vmax: float):
    """matplotlib's Normalize(vmin, vmax): 0 everywhere when vmin == vmax."""
    v = np.asarray(v, dtype=np.float64)
    return np.zeros_like(v) if vmax == vmin else (v - vmin) / (vmax - vmin)


def colorbar_ticks(class_values) -> list:
    """The colour bar's ticks: the class values, or 20 evenly spaced
    integers when there are more than 20."""
    ticks = [float(c) for c in class_values]
    if len(ticks) > 20:
        ticks = np.linspace(min(ticks), max(ticks), 20, dtype=int).tolist()
    return ticks


def choose(preds, ys, num: int = 5, sort_by: str = "prediction") -> list:
    """Indices of the drawn graphs: the `num` highest then the `num` lowest
    by prediction, by true rating (`sort_by="true"`) or in a
    np.random.permutation (anything else), ranked with np.argsort as the
    JAX package ranks them (ratings tie; only the same call orders ties
    the same)."""
    if sort_by == "true":
        order = np.argsort(ys).tolist()
    elif sort_by == "prediction":
        order = np.argsort(preds).tolist()
    else:
        order = np.random.permutation(len(preds)).tolist()
    return order[-num:][::-1] + order[:num]


def predict(model, dataset, batch_size: int = 50, device="cuda"):
    """(predictions, targets) of every graph of `dataset` in dataset order,
    as float32 NumPy arrays: a copy of `model` in eval mode on the flat
    segment engine over a plain flat BatchLoader (make_eval_step +
    predict_all)."""
    from .loop import _flat_model, make_eval_step, predict_all

    dev = resolve_device(device)
    model = _flat_model(copy.deepcopy(model).to(dev).eval(), "segment")
    loader = BatchLoader(dataset, batch_size, pin_memory=dev.type == "cuda")
    return predict_all(make_eval_step(model), loader, dev)


def _grid_boxes(num: int) -> list:
    """(x, y, w, h) in points of the 2 x num panels, row by row from the
    top, as matplotlib's GridSpec places them."""
    g = GRID
    cw = (g["right"] - g["left"]) / (num + g["wspace"] * (num - 1))
    rh = (g["top"] - g["bottom"]) / (2 + g["hspace"])
    boxes = []
    for r in range(2):
        y = g["top"] - rh - r * rh * (1 + g["hspace"])
        for c in range(num):
            x = g["left"] + c * cw * (1 + g["wspace"])
            boxes.append((x * PAGE_W, y * PAGE_H, cw * PAGE_W, rh * PAGE_H))
    return boxes


def _limits(values) -> tuple:
    """An axis' view limits: the data range padded by 5% (networkx's draw
    pad), then matplotlib's 5% margins."""
    lo, hi = float(np.min(values)), float(np.max(values))
    if hi == lo:
        lo, hi = lo - 1.0, hi + 1.0
    pad = 0.05 * (hi - lo)
    lo, hi = lo - pad, hi + pad
    m = 0.05 * (hi - lo)
    return lo - m, hi + m


def _tick_labels(ticks) -> list:
    decimals = max((len(f"{t:g}".split(".")[1]) if "." in f"{t:g}" else 0)
                   for t in ticks) if ticks else 0
    return [f"{t:.{decimals}f}" for t in ticks]


def draw_panel(page: Page, box, g, class_values, title: str) -> None:
    """One subgraph into `box` of `page`: its edges, its nodes, the target
    user (node 0) and target item (node num of users, if it exists) again
    on top, and the title under the panel."""
    x0, y0, w, h = box
    edges, node_label = subgraph_edges(g)
    n = len(node_label)
    u_nodes = [i for i in range(n) if node_label[i] % 2 == 0]
    pos = bipartite_layout(n, u_nodes)
    (xlo, xhi), (ylo, yhi) = _limits(pos[:, 0]), _limits(pos[:, 1])
    px = x0 + (pos[:, 0] - xlo) / (xhi - xlo) * w
    py = y0 + (pos[:, 1] - ylo) / (yhi - ylo) * h
    vmin, vmax = float(min(class_values)), float(max(class_values))
    for (a, b), t in edges.items():
        rgb = rainbow(_normalize(float(class_values[t]), vmin, vmax))
        page.line(px[a], py[a], px[b], py[b], rgb, width=1.0)
    for i in range(n):
        page.disc(px[i], py[i], NODE_RADIUS, node_color(node_label[i]))
    page.disc(px[0], py[0], NODE_RADIUS, TYPE_COLORS[0])
    v0 = len(u_nodes)
    if v0 < n:
        page.disc(px[v0], py[v0], NODE_RADIUS, TYPE_COLORS[1])
    page.text(x0 + w / 2, y0 - 0.05 * h, title, TITLE_SIZE, anchor="center")


def draw_colorbar(page: Page, class_values) -> None:
    """The rainbow colour bar: 256 bands from the lowest to the highest
    class value, an outline, and the ticks with their labels."""
    x, y, w, h = (COLORBAR[0] * PAGE_W, COLORBAR[1] * PAGE_H,
                  COLORBAR[2] * PAGE_W, COLORBAR[3] * PAGE_H)
    for i, rgb in enumerate(RAINBOW):
        page.rect(x, y + i * h / 256, w, h / 256 + 0.05, rgb)
    page.rect(x, y, w, h, (0, 0, 0), fill=False, width=0.8)
    vmin, vmax = float(min(class_values)), float(max(class_values))
    ticks = [t for t in colorbar_ticks(class_values) if vmin <= t <= vmax]
    for t, label in zip(ticks, _tick_labels(ticks)):
        ty = y + float(_normalize(t, vmin, vmax)) * h
        page.rect(x + w, ty - 0.4, 3.5, 0.8, (0, 0, 0))
        page.text(x + w + 7.0, ty - 0.36 * TICK_SIZE, label, TICK_SIZE)


def draw(graphs, titles, class_values, path: str, num: int = 5) -> None:
    """Write the 2 x `num` panels of `graphs` with `titles` and the colour
    bar to the PDF `path`."""
    page = Page(PAGE_W, PAGE_H)
    for box, g, title in zip(_grid_boxes(num), graphs, titles):
        draw_panel(page, box, g, class_values, title)
    draw_colorbar(page, class_values)
    page.save(path)


def visualize(model, dataset, res_dir, data_name, class_values, batch_size=50,
              num=5, sort_by="prediction", device="cuda"):
    """Predict over `dataset` with `model` on `device`, choose the top and
    bottom `num` graphs (`choose`), draw them into
    <res_dir>/visualization_<data_name>_<sort_by>.pdf, print
    `saved <path>` and return the path."""
    preds, ys = predict(model, dataset, batch_size, device)
    idx = choose(preds, ys, num, sort_by)
    graphs = [dataset.get(i) for i in idx]
    titles = ["{:.4f} ({:})".format(preds[i], ys[i]) for i in idx]
    out = os.path.join(res_dir, f"visualization_{data_name}_{sort_by}.pdf")
    draw(graphs, titles, class_values, out, num)
    print(f"saved {out}")
    return out
