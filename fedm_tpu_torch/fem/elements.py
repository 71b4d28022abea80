"""P1 triangle tabulation and quadrature rules (host numpy).

Reference triangle: vertices (0,0), (1,0), (0,1). The rules are the JAX
package's (Dunavant symmetric rules, weights summing to the area 1/2), so
quadrature tables agree bit for bit.
"""

from __future__ import annotations

import numpy as np


def tabulate(points: np.ndarray):
    """P1 shape functions and reference gradients at `points` [n_pts, 2].
    Returns (N [n_pts, 3], dN [n_pts, 3, 2])."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    xi, eta = points[:, 0], points[:, 1]
    N = np.stack([1.0 - xi - eta, xi, eta], axis=1)
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    dN = np.broadcast_to(dlam, (len(xi), 3, 2)).copy()
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


def cell_quadrature(degree: int):
    """Triangle rule exact for polynomials of `degree` (capped at 6).
    Returns (points [n_q, 2], weights [n_q])."""
    pts, wts = _TRI_RULES[min(max(degree, 1), 6)]
    return pts.copy(), wts.copy()


def facet_quadrature(degree: int):
    """Gauss-Legendre rule on the unit interval parameterising an edge."""
    x, w = np.polynomial.legendre.leggauss(max(1, (degree + 2) // 2))
    return (0.5 * (x + 1.0))[:, None], 0.5 * w
