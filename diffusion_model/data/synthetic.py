"""Synthetic SiO2 local-environment dataset generator.

The reference's raw data (CASTEP ``coreloss.cell`` + EELS spectra) lives on
private paths (ref make_dataset.py args, data_preparation.py:412), so tests
and benchmarks need a generator producing the exact dataset schema
(ref make_dataset.py:110-142):

  * node 0 = excited oxygen (exO) at the origin, species one-hot O=[1,0]
  * CN Si neighbours at ~1.62 A (Si-O bond length in silica) with
    tetrahedral-ish geometry, species Si=[0,1]
  * optional second shell of bridging O at ~1.6 A from each Si
  * per-node spectrum tensor with only row 0 (exO) carrying the real
    200-point curve (ref make_dataset.py:125-128)
  * exO indicator column, id string

The synthetic EELS curve encodes the coordination number (peak positions /
widths shift with CN) so conditional models have real signal to learn.
"""

from __future__ import annotations

import numpy as np


SI_O_BOND = 1.62  # Angstrom, typical silica bond length


def _random_unit_vectors(rng: np.random.Generator, n: int,
                         min_angle_deg: float = 60.0) -> np.ndarray:
    """n unit vectors pairwise separated by at least ``min_angle_deg``."""
    cos_max = np.cos(np.radians(min_angle_deg))
    vecs: list[np.ndarray] = []
    while len(vecs) < n:
        v = rng.normal(size=3)
        v /= np.linalg.norm(v)
        if all(np.dot(v, u) < cos_max for u in vecs):
            vecs.append(v)
    return np.stack(vecs)


def synthetic_spectrum(cn: int, rng: np.random.Generator,
                       size: int = 200,
                       mean_angle_deg: float | None = None) -> np.ndarray:
    """ELNES-like curve on the reference's -1..19 eV grid.

    Two Gaussian peaks whose centres/amplitudes shift with coordination
    number, plus (when ``mean_angle_deg`` is given) a third peak whose
    centre tracks the mean bond angle — so the conditioning genuinely
    determines the local geometry and conditional parity metrics (CN2
    angle R^2) are information-theoretically achievable. Min-max normalised
    like ``fitted_intensity`` (ref data_preparation.py:186-200).
    """
    ev = np.linspace(-1.0, 19.0, size)
    c1 = 5.0 + 1.2 * cn + rng.normal(0, 0.15)
    c2 = 11.0 + 0.8 * cn + rng.normal(0, 0.2)
    w1 = 1.2 + 0.1 * cn
    w2 = 2.5
    a2 = 0.5 + 0.1 * cn
    y = (
        np.exp(-0.5 * ((ev - c1) / w1) ** 2)
        + a2 * np.exp(-0.5 * ((ev - c2) / w2) ** 2)
    )
    if mean_angle_deg is not None:
        c3 = -0.5 + 4.0 * (mean_angle_deg / 180.0) + rng.normal(0, 0.05)
        y += 0.7 * np.exp(-0.5 * ((ev - c3) / 0.6) ** 2)
    y += rng.normal(0, 0.01, size)
    y -= y.min()
    y /= max(y.max(), 1e-9)
    return y.astype(np.float32)


def make_graph(rng: np.random.Generator, n_max: int, spectrum_size: int = 200,
               shells: int = 1, cn: int | None = None) -> dict:
    """One synthetic local environment as a graph dict."""
    if cn is None:
        cn = int(rng.integers(2, 5))  # CN in {2,3,4}
    dirs = _random_unit_vectors(rng, cn)
    # mean pairwise angle between neighbour directions — encoded in the
    # spectrum so conditioning determines geometry
    angles = []
    for i in range(cn):
        for j in range(i + 1, cn):
            angles.append(np.degrees(np.arccos(
                np.clip(np.dot(dirs[i], dirs[j]), -1.0, 1.0)
            )))
    mean_angle = float(np.mean(angles)) if angles else 180.0
    pos = [np.zeros(3)]
    species = [[1.0, 0.0]]  # exO is oxygen
    for d in dirs:
        r = SI_O_BOND + rng.normal(0, 0.04)
        pos.append(d * r)
        species.append([0.0, 1.0])  # Si
    if shells >= 2:
        for i in range(cn):
            if len(pos) >= n_max:
                break
            si = pos[1 + i]
            out_dir = si / np.linalg.norm(si)
            perp = np.cross(out_dir, rng.normal(size=3))
            perp /= np.linalg.norm(perp)
            bridge = out_dir * 0.5 + perp * 0.87
            bridge /= np.linalg.norm(bridge)
            pos.append(si + bridge * (SI_O_BOND + rng.normal(0, 0.04)))
            species.append([1.0, 0.0])  # bridging O
    pos = np.asarray(pos, np.float32)
    species = np.asarray(species, np.float32)
    n = pos.shape[0]
    spectrum = np.zeros((n, spectrum_size), np.float32)
    spectrum[0] = synthetic_spectrum(cn, rng, spectrum_size,
                                     mean_angle_deg=mean_angle)
    exo = np.zeros((n, 1), np.float32)
    exo[0, 0] = 1.0
    return {
        "pos": pos,
        "species": species,
        "spectrum": spectrum,
        "exo": exo,
        "cn": cn,
        "mean_angle_deg": mean_angle,
        "id": f"synthetic_{rng.integers(1 << 30)}",
    }


def synthetic_sio2_dataset(seed: int, num_graphs: int, n_max: int,
                           spectrum_size: int = 200,
                           shells: int = 1) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [
        make_graph(rng, n_max, spectrum_size, shells)
        for _ in range(num_graphs)
    ]


def synthetic_molecule_dataset(seed: int, num_graphs: int, n_max: int,
                               atom_type_size: int = 5,
                               spectrum_size: int = 200) -> list[dict]:
    """Generic multi-species molecular clusters — the public smoke-test
    analogue of the reference's QM9 path (ref main.py:43,90-95,145-152:
    atom_type_size widens to 5 there). Random species one-hots over
    ``atom_type_size`` classes, bond lengths keyed to the species index."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(num_graphs):
        n = int(rng.integers(3, min(n_max, 9) + 1))
        types = rng.integers(0, atom_type_size, n)
        dirs = _random_unit_vectors(rng, n - 1, min_angle_deg=40.0)
        pos = [np.zeros(3)]
        for i in range(n - 1):
            r = 1.0 + 0.15 * types[i + 1] + rng.normal(0, 0.03)
            pos.append(dirs[i] * r)
        pos = np.asarray(pos, np.float32)
        species = np.eye(atom_type_size, dtype=np.float32)[types]
        spectrum = np.zeros((n, spectrum_size), np.float32)
        spectrum[0] = synthetic_spectrum(int(types.sum() % 3 + 2), rng,
                                         spectrum_size)
        exo = np.zeros((n, 1), np.float32)
        exo[0, 0] = 1.0
        out.append({
            "pos": pos, "species": species, "spectrum": spectrum,
            "exo": exo, "id": f"mol_{seed}_{g}",
        })
    return out


def amorphous_cell(seed: int, num_atoms: int, density_si_ratio: float = 1 / 3,
                   spectrum_size: int = 200) -> dict:
    """A larger amorphous-like SiO2 cell for the big-graph benchmark path
    (driver config #4: 1024+ atoms). Atoms drawn with a minimum-distance
    rejection loop inside a cube sized for silica's number density."""
    rng = np.random.default_rng(seed)
    # amorphous SiO2: ~0.066 atoms/A^3
    side = (num_atoms / 0.066) ** (1 / 3)
    pos: list[np.ndarray] = []
    while len(pos) < num_atoms:
        cand = rng.uniform(0, side, 3)
        if all(np.sum((cand - p) ** 2) > 1.4**2 for p in pos[-200:]):
            pos.append(cand)
    pos = np.asarray(pos, np.float32)
    pos -= pos[0]  # exO at origin
    n_si = int(num_atoms * density_si_ratio)
    species = np.zeros((num_atoms, 2), np.float32)
    species[:, 0] = 1.0
    si_idx = rng.choice(np.arange(1, num_atoms), n_si, replace=False)
    species[si_idx] = [0.0, 1.0]
    spectrum = np.zeros((num_atoms, spectrum_size), np.float32)
    spectrum[0] = synthetic_spectrum(4, rng, spectrum_size)
    exo = np.zeros((num_atoms, 1), np.float32)
    exo[0, 0] = 1.0
    return {
        "pos": pos,
        "species": species,
        "spectrum": spectrum,
        "exo": exo,
        "cn": 4,
        "id": f"amorphous_{seed}",
    }


def amorphous_network_cell(seed: int, num_atoms: int,
                           spectrum_size: int = 200,
                           bond_length: float = 1.61,
                           si_o_si_deg: float = 147.0,
                           jitter: float = 0.12) -> dict:
    """A continuous-random-network SiO2 cluster with real chemical order.

    ``amorphous_cell`` is a hard-sphere packing — adequate for throughput
    benchmarks but with no Si-O bonds, no coordination shells and no
    mid-range order, so its exO-RDF aggregate is dominated by envelope
    sample noise (disjoint ground-truth sets of 8 cells agree only to
    ~0.76 cosine at 512 atoms — measured round 3). This generator builds
    the quasi-amorphous network model instead: a beta-cristobalite Si
    sublattice (diamond lattice, the standard crystalline reference for
    silica glass) with every bridging O displaced off the Si-Si axis to
    the target Si-O-Si angle at the target bond length, Gaussian
    positional disorder, a random global rotation, and a ball of the
    ``num_atoms`` sites nearest a randomly chosen exO. The result has
    silica's number density (0.066 atoms/A^3 falls out of the geometry),
    CN(Si)=4 / CN(O)=2 short-range order and genuine mid-range peaks —
    i.e. the structure the reference's amorphous pipeline actually
    studies (ref generate_amorphous.py:25-147, evaluate_Si-O-Si.py).

    Dataset schema matches make_dataset.py:110-142 like the other
    generators; the exO spectrum encodes CN=2 and the exO's actual
    Si-O-Si angle so conditioning stays informative.
    """
    rng = np.random.default_rng(seed)
    theta = np.radians(si_o_si_deg)
    # Geometry: Si-Si nn distance and diamond lattice constant follow
    # from the bond length and bridge angle.
    d_sisi = 2.0 * bond_length * np.sin(theta / 2.0)
    a = 4.0 * d_sisi / np.sqrt(3.0)
    delta = bond_length * np.cos(theta / 2.0)  # O off-axis displacement

    # Ball radius for num_atoms at the implied density (24 atoms/cell).
    density = 24.0 / a**3
    radius = (num_atoms / density * 3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    ncell = int(np.ceil((radius + a) / a))

    # Diamond Si sublattice.
    fcc = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    basis = np.concatenate([fcc, fcc + 0.25])
    cells = np.arange(-ncell, ncell + 1)
    grid = np.stack(np.meshgrid(cells, cells, cells,
                                indexing="ij"), -1).reshape(-1, 3)
    si = ((grid[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
          ).astype(np.float64)
    si = si[np.linalg.norm(si, axis=-1) < radius + a]

    # Unique bonded Si pairs (nearest neighbours at d_sisi).
    from scipy.spatial import cKDTree
    tree = cKDTree(si)
    pairs = tree.query_pairs(d_sisi * 1.05, output_type="ndarray")

    # Bridging O: midpoint + perpendicular offset with random azimuth.
    mid = 0.5 * (si[pairs[:, 0]] + si[pairs[:, 1]])
    axis = si[pairs[:, 1]] - si[pairs[:, 0]]
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    rand = rng.normal(size=axis.shape)
    perp = rand - np.sum(rand * axis, axis=-1, keepdims=True) * axis
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    ox = mid + delta * perp

    pos = np.concatenate([si, ox])
    is_o = np.zeros(len(pos), bool)
    is_o[len(si):] = True
    pos = pos + rng.normal(0.0, jitter, pos.shape)

    # Random global rotation (QR sign-fixed).
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    pos = pos @ q.T

    # exO: the O site nearest the cluster centre; carve the ball there.
    o_idx = np.nonzero(is_o)[0]
    exo_site = o_idx[np.argmin(np.linalg.norm(pos[o_idx], axis=-1))]
    pos = pos - pos[exo_site]
    order = np.argsort(np.linalg.norm(pos, axis=-1), kind="stable")
    keep = order[:num_atoms]  # keep[0] == exo_site (distance 0)
    pos_k = pos[keep].astype(np.float32)
    is_o_k = is_o[keep]

    species = np.zeros((num_atoms, 2), np.float32)
    species[is_o_k] = [1.0, 0.0]
    species[~is_o_k] = [0.0, 1.0]

    # exO's actual Si-O-Si angle (pre-carve neighbours survive: they are
    # at bond_length, well inside the ball).
    si_k = pos_k[~is_o_k]
    d_ex = np.linalg.norm(si_k, axis=-1)
    nb = si_k[np.argsort(d_ex)[:2]]
    cosang = np.dot(nb[0], nb[1]) / (
        np.linalg.norm(nb[0]) * np.linalg.norm(nb[1]))
    angle = float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))

    spectrum = np.zeros((num_atoms, spectrum_size), np.float32)
    spectrum[0] = synthetic_spectrum(2, rng, spectrum_size,
                                     mean_angle_deg=angle)
    exo_col = np.zeros((num_atoms, 1), np.float32)
    exo_col[0, 0] = 1.0
    return {
        "pos": pos_k,
        "species": species,
        "spectrum": spectrum,
        "exo": exo_col,
        "cn": 2,
        "id": f"network_{seed}",
    }


def cached_cell(maker, cache_dir: str, **kw) -> dict:
    """Disk-memoised synthetic cell generation.

    Host-side CRN/packing generation is the slow part of large-cell run
    startup (~6 min for 96 cells at 448-512 atoms), and it is repaid on
    every ``--resume`` relaunch. The cache key is
    the maker's name plus its sorted kwargs; the payload is the graph
    dict as one ``.npz``. Writes are atomic (tmp file + ``os.replace``)
    so a kill mid-generation can never leave a truncated entry.
    """
    import os

    key = "_".join(
        [maker.__name__] + [f"{k}={kw[k]}" for k in sorted(kw)]
    )
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        out = {k: z[k] for k in z.files}
        out["id"] = str(out["id"])
        out["cn"] = int(out["cn"])
        return out
    g = maker(**kw)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **g)
    os.replace(tmp, path)
    return g
