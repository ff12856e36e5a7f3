"""Synthetic discogs-like XML corpus with a controllable redundancy profile.

The paper evaluates on the 12.6GB discogs.com dump (4.2M <release> records).
Offline we synthesize a structurally faithful catalog whose redundancy profile
matches Table III:

  category 1 (0% savings)   image/uri/release/identifiers — every <images>,
                            <identifiers>, <tracklist> subtree is unique, so
                            nothing above them compresses;
  category 2 (~60-90%)      vinyl/electronic/12"/uk — keyword-bearing leaf
                            subtrees (genre, country, format name) repeat and
                            compress, but their CAs (releases) do not;
  category 3 (~95%+)        description/rpm/45/7" — whole <formats> subtrees
                            are drawn from a small pool and dedupe wholesale,
                            so results themselves live in repeated structure.

Everything is deterministic given (n_releases, seed).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.xml_tree import NodeSpec, XMLTree, build_tree

# paper Table I queries, transposed onto the synthetic vocabulary
QUERIES: dict[str, tuple[int, list[str]]] = {
    "Q1": (1, ["image", "uri"]),
    "Q2": (1, ["image", "uri", "release"]),
    "Q3": (1, ["image", "uri", "release", "identifiers"]),
    "Q4": (2, ["vinyl", "electronic"]),
    "Q5": (2, ["vinyl", "electronic", '12"']),
    "Q6": (2, ["vinyl", "electronic", '12"', "uk"]),
    "Q7": (3, ["description", "rpm"]),
    "Q8": (3, ["description", "rpm", "45"]),
    "Q9": (3, ["description", "rpm", "45", '7"']),
}

_GENRES = [
    "electronic", "rock", "jazz", "funk", "soul", "pop", "classical",
    "hip-hop", "latin", "reggae", "blues", "folk", "country", "stage", "brass",
]
_STYLES = [
    "house", "techno", "ambient", "disco", "punk", "hardcore", "ska", "dub",
    "swing", "bebop", "fusion", "grunge", "synth-pop", "trance", "acid",
    "minimal", "breaks", "garage", "downtempo", "experimental",
]
_COUNTRIES = [
    "us", "uk", "germany", "france", "japan", "italy", "netherlands",
    "canada", "spain", "australia", "sweden", "belgium", "brazil", "portugal",
]
_FORMAT_POOL: list[tuple[str, list[str]]] = [
    ("vinyl", ['12"', "33", "rpm", "album"]),
    ("vinyl", ['12"', "45", "rpm"]),
    ("vinyl", ['7"', "45", "rpm", "single"]),
    ("vinyl", ['7"', "45", "rpm", "ep"]),
    ("vinyl", ['10"', "78", "rpm"]),
    ("vinyl", ["lp", "album", "reissue"]),
    ("vinyl", ["lp", "album", "repress"]),
    ("cd", ["album"]),
    ("cd", ["album", "reissue"]),
    ("cd", ["single"]),
    ("cd", ["compilation"]),
    ("cassette", ["album"]),
    ("cassette", ["single"]),
    ("file", ["mp3", "320", "kbps"]),
    ("file", ["flac", "album"]),
    ("vinyl", ['12"', "maxi-single", "45", "rpm"]),
    ("vinyl", ['12"', "limited", "edition", "45", "rpm"]),
    ("vinyl", ['7"', "promo", "45", "rpm"]),
    ("cd", ["album", "limited", "edition"]),
    ("dvd", ["pal"]),
]


@dataclass
class DiscogsConfig:
    n_releases: int = 1000
    seed: int = 0
    n_artists: int = 200
    n_labels: int = 120
    max_tracks: int = 6


def _format_node(fmt_idx: int) -> NodeSpec:
    name, descs = _FORMAT_POOL[fmt_idx % len(_FORMAT_POOL)]
    return NodeSpec(
        "formats",
        children=[
            NodeSpec(
                "format",
                children=[
                    NodeSpec("name", name),
                    NodeSpec("qty", "1"),
                    NodeSpec(
                        "descriptions",
                        children=[NodeSpec("description", d) for d in descs],
                    ),
                ],
            )
        ],
    )


def generate_release(rng: np.random.Generator, rid: int, cfg: DiscogsConfig) -> NodeSpec:
    # unique-per-release leaves keep category-1 regions incompressible
    images = NodeSpec(
        "images",
        children=[
            NodeSpec(
                "image",
                children=[
                    NodeSpec("height", str(400 + rid % 1213)),
                    NodeSpec("width", str(400 + (rid * 7) % 1217)),
                    NodeSpec("type", "primary"),
                    NodeSpec("uri", f"img-{rid}.jpg"),
                    NodeSpec("uri150", f"img-{rid}-150.jpg"),
                ],
            )
        ],
    )
    artist = int(rng.integers(0, cfg.n_artists))
    label = int(rng.integers(0, cfg.n_labels))
    fmt = int(rng.integers(0, len(_FORMAT_POOL)))
    n_tracks = 1 + int(rng.integers(0, cfg.max_tracks))
    genre = _GENRES[int(rng.integers(0, len(_GENRES)))]
    style = _STYLES[int(rng.integers(0, len(_STYLES)))]
    country = _COUNTRIES[int(rng.integers(0, len(_COUNTRIES)))]
    year = str(1950 + int(rng.integers(0, 73)))

    return NodeSpec(
        "release",
        children=[
            NodeSpec("id", str(rid)),
            NodeSpec("status", "accepted"),
            images,
            NodeSpec(
                "artists",
                children=[
                    NodeSpec(
                        "artist",
                        children=[
                            NodeSpec("artist-id", str(artist)),
                            NodeSpec("name", f"artist-{artist}"),
                        ],
                    )
                ],
            ),
            NodeSpec("title", f"title-{rid}-{int(rng.integers(0, 1 << 30))}"),
            NodeSpec(
                "labels",
                children=[
                    NodeSpec(
                        "label",
                        children=[
                            NodeSpec("catno", f"cat-{label}-{rid % 97}"),
                            NodeSpec("label-name", f"label-{label}"),
                        ],
                    )
                ],
            ),
            _format_node(fmt),
            NodeSpec("genres", children=[NodeSpec("genre", genre)]),
            NodeSpec("styles", children=[NodeSpec("style", style)]),
            NodeSpec("country", country),
            NodeSpec("released", year),
            NodeSpec(
                "identifiers",
                children=[
                    NodeSpec(
                        "identifier",
                        children=[
                            NodeSpec("id-type", "barcode"),
                            NodeSpec("value", f"{rid:012d}"),
                        ],
                    )
                ],
            ),
            NodeSpec(
                "tracklist",
                children=[
                    NodeSpec(
                        "track",
                        children=[
                            NodeSpec("position", str(t + 1)),
                            NodeSpec(
                                "track-title",
                                f"trk-{rid}-{t}-{int(rng.integers(0, 1 << 30))}",
                            ),
                            NodeSpec(
                                "duration",
                                f"{int(rng.integers(1, 9))}:{int(rng.integers(0, 60)):02d}",
                            ),
                        ],
                    )
                    for t in range(n_tracks)
                ],
            ),
        ],
    )


def generate_discogs_tree(cfg: DiscogsConfig | None = None, **kw) -> XMLTree:
    """Build the synthetic catalog as an XMLTree (no XML round-trip)."""
    cfg = cfg or DiscogsConfig(**kw)
    rng = np.random.default_rng(cfg.seed)
    releases = [generate_release(rng, rid, cfg) for rid in range(cfg.n_releases)]
    return build_tree(NodeSpec("releases", children=releases))


def to_xml(node: NodeSpec, indent: int = 0) -> str:
    """Render a NodeSpec as XML text (for the example scripts)."""
    pad = " " * indent
    open_tag = f"{pad}<{node.label}>"
    if not node.children:
        return f"{open_tag}{node.text}</{node.label}>"
    inner = "\n".join(to_xml(c, indent + 2) for c in node.children)
    text = node.text if node.text else ""
    return f"{open_tag}{text}\n{inner}\n{pad}</{node.label}>"
