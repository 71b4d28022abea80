"""Lagrange P1/P2 tabulation on intervals and triangles, and quadrature
rules (host numpy).

Reference cells: the interval [0, 1]; the triangle (0,0), (1,0), (0,1).
Local dof order: vertices first, then edge midpoints, edge dof i opposite
vertex i (triangle P2: [v0, v1, v2, e0=(v1,v2), e1=(v0,v2), e2=(v0,v1)];
interval P2: [v0, v1, midpoint]). The rules are the JAX package's
(Gauss-Legendre on intervals, Dunavant symmetric rules with weights summing
to the area 1/2 on triangles), so tables agree bit for bit.
"""

from __future__ import annotations

import numpy as np


def n_local_dofs(cell: str, degree: int) -> int:
    if cell == "interval":
        return degree + 1
    if cell == "triangle":
        return {1: 3, 2: 6}[degree]
    raise ValueError(f"unknown cell type '{cell}'")


def tabulate(cell: str, degree: int, points: np.ndarray):
    """Shape functions and their reference gradients at `points`
    [n_pts, dim]. Returns (N [n_pts, n_local], dN [n_pts, n_local, dim])."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    if cell == "interval":
        x = points[:, 0]
        if degree == 1:
            N = np.stack([1.0 - x, x], axis=1)
            dN = np.broadcast_to(np.array([[-1.0], [1.0]]),
                                 (len(x), 2, 1)).copy()
        elif degree == 2:
            N = np.stack([(1 - x) * (1 - 2 * x), x * (2 * x - 1),
                          4 * x * (1 - x)], axis=1)
            dN = np.stack([4 * x - 3, 4 * x - 1, 4 - 8 * x],
                          axis=1)[:, :, None]
        else:
            raise ValueError("interval degree must be 1 or 2")
        return N, dN
    if cell != "triangle":
        raise ValueError(f"unknown cell type '{cell}'")
    xi, eta = points[:, 0], points[:, 1]
    lam = np.stack([1.0 - xi - eta, xi, eta], axis=1)  # barycentric
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    if degree == 1:
        return lam, np.broadcast_to(dlam, (len(xi), 3, 2)).copy()
    if degree != 2:
        raise ValueError("triangle degree must be 1 or 2")
    l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
    N = np.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                  4 * l1 * l2, 4 * l0 * l2, 4 * l0 * l1], axis=1)
    dN = np.zeros((len(xi), 6, 2))
    for d in range(2):
        g0, g1, g2 = dlam[0, d], dlam[1, d], dlam[2, d]
        dN[:, 0, d] = (4 * l0 - 1) * g0
        dN[:, 1, d] = (4 * l1 - 1) * g1
        dN[:, 2, d] = (4 * l2 - 1) * g2
        dN[:, 3, d] = 4 * (g1 * l2 + l1 * g2)
        dN[:, 4, d] = 4 * (g0 * l2 + l0 * g2)
        dN[:, 5, d] = 4 * (g0 * l1 + l0 * g1)
    return N, dN


def _sym_rule(pairs):
    """Points (a, a), (b, a), (a, b) with b = 1 - 2a for each (a, w)."""
    pts, wts = [], []
    for a, w in pairs:
        b = 1.0 - 2.0 * a
        pts += [[a, a], [b, a], [a, b]]
        wts += [w / 2] * 3
    return pts, wts


def _rule_deg4():
    pts, wts = _sym_rule([(0.445948490915965, 0.223381589678011),
                          (0.091576213509771, 0.109951743655322)])
    return np.array(pts), np.array(wts)


def _rule_deg5():
    pts, wts = _sym_rule([(0.470142064105115, 0.132394152788506),
                          (0.101286507323456, 0.125939180544827)])
    return np.array([[1 / 3, 1 / 3]] + pts), np.array([0.225 / 2] + wts)


def _rule_deg6():
    pts, wts = _sym_rule([(0.249286745170910, 0.116786275726379),
                          (0.063089014491502, 0.050844906370207)])
    c, d, w3 = 0.310352451033785, 0.053145049844816, 0.082851075618374
    e = 1.0 - c - d
    for p in [[c, d], [d, c], [c, e], [e, c], [d, e], [e, d]]:
        pts.append(p)
        wts.append(w3 / 2)
    return np.array(pts), np.array(wts)


_TRI_RULES = {
    1: (np.array([[1 / 3, 1 / 3]]), np.array([0.5])),
    2: (np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
        np.full(3, 1 / 6)),
    3: _rule_deg4(),
    4: _rule_deg4(),
    5: _rule_deg5(),
    6: _rule_deg6(),
}


def _gauss_01(n: int):
    """n-point Gauss-Legendre on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def cell_quadrature(cell: str, degree: int):
    """Rule exact for polynomials of `degree` on the reference cell:
    Gauss-Legendre on intervals, the Dunavant rules on triangles (capped
    at 6). Returns (points [n_q, dim], weights [n_q])."""
    if cell == "interval":
        x, w = _gauss_01(max(1, (degree + 2) // 2))
        return x[:, None], w
    if cell == "triangle":
        pts, wts = _TRI_RULES[min(max(degree, 1), 6)]
        return pts.copy(), wts.copy()
    raise ValueError(f"unknown cell type '{cell}'")


def facet_quadrature(cell_dim: int, degree: int):
    """Rule on the reference facet: a single point for 1D cells, the
    Gauss-Legendre rule on the unit interval parameterising an edge for
    2D cells."""
    if cell_dim == 1:
        return np.zeros((1, 0)), np.ones(1)
    x, w = _gauss_01(max(1, (degree + 2) // 2))
    return x[:, None], w
