"""Butcher tableaus of the explicit and implicit Runge-Kutta methods.

A numpy-only copy of the tables in ``torchdiffeq_tpu/ops/tableaus.py`` (the
JAX package's module cannot be imported without importing JAX).  The
numbers are the same published constants, written the same way, so the two
copies are equal bit for bit (tests/test_torch_tables.py checks it) -- this
includes tsit5's swapped weight pairs (COVERAGE.md, "Known deviations") and
the `implicit` and `sdirk` flags of the implicit tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    """Explicit (or implicit) RK tableau.

    alpha:   (s-1,) stage times, excluding the initial stage at alpha=0
             (explicit); all `s` stage times (implicit).
    beta:    (s-1, s-1) zero-padded stage-coupling matrix; row i gives the
             coefficients of stages 0..i for computing stage i+1
             (explicit), or the full (s, s) coupling matrix (implicit).
    c_sol:   (s,) solution weights.
    c_error: (s,) embedded error weights (empty for implicit fixed-grid).
    c_mid:   (s,) mid-point weights for 4th-order dense output.
    order:   convergence order used by the step-size controller.
    implicit, sdirk: an implicit tableau, and one whose stages are solved
             one at a time (DIRK) rather than as one system (FIRK).
    """
    alpha: np.ndarray
    beta: np.ndarray
    c_sol: np.ndarray
    c_error: np.ndarray
    order: int
    c_mid: np.ndarray | None = None
    implicit: bool = False
    sdirk: bool = False

    @property
    def n_stages(self) -> int:
        return len(self.c_sol)

    @property
    def is_fsal(self) -> bool:
        """First-same-as-last: the final stage equals f(t1, y1), so the
        solution combination is free and f1 carries to the next step."""
        if self.implicit or len(self.c_sol) < 2 or self.beta.shape[0] == 0:
            return False
        return bool(self.c_sol[-1] == 0.0 and
                    np.array_equal(self.c_sol[:-1], self.beta[-1]))


def _tab(alpha, beta_rows, c_sol, c_error, order, c_mid=None, implicit=False,
         sdirk=False):
    alpha = np.asarray(alpha, dtype=np.float64)
    s = len(beta_rows)
    width = max((len(r) for r in beta_rows), default=0)
    beta = np.zeros((s, width), dtype=np.float64)
    for i, row in enumerate(beta_rows):
        beta[i, :len(row)] = row
    return ButcherTableau(
        alpha=alpha, beta=beta,
        c_sol=np.asarray(c_sol, dtype=np.float64),
        c_error=np.asarray(c_error, dtype=np.float64),
        c_mid=None if c_mid is None else np.asarray(c_mid, dtype=np.float64),
        order=order, implicit=implicit, sdirk=sdirk)


# ---------------------------------------------------------------------------
# Adaptive explicit methods
# ---------------------------------------------------------------------------

# Dormand-Prince 4(5).  Reference: torchdiffeq/_impl/dopri5.py:5-30.
DOPRI5 = _tab(
    alpha=[1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1.],
    beta_rows=[
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ],
    c_sol=[35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    c_error=[
        35 / 384 - 1951 / 21600,
        0,
        500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720,
        -2187 / 6784 - -12231 / 42400,
        11 / 84 - 649 / 6300,
        -1. / 60.,
    ],
    c_mid=[
        6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
    ],
    order=5,
)

# Bogacki-Shampine 2(3).  Reference: torchdiffeq/_impl/bosh3.py.
BOSH3 = _tab(
    alpha=[1 / 2, 3 / 4, 1.],
    beta_rows=[
        [1 / 2],
        [0., 3 / 4],
        [2 / 9, 1 / 3, 4 / 9],
    ],
    c_sol=[2 / 9, 1 / 3, 4 / 9, 0.],
    c_error=[2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8],
    c_mid=[0., 0.5, 0., 0.],
    order=3,
)

# Runge-Kutta-Fehlberg 1(2).  Reference: torchdiffeq/_impl/fehlberg2.py.
FEHLBERG2 = _tab(
    alpha=[1 / 2, 1.0],
    beta_rows=[
        [1 / 2],
        [1 / 256, 255 / 256],
    ],
    c_sol=[1 / 512, 255 / 256, 1 / 512],
    c_error=[-1 / 512, 0, 1 / 512],
    c_mid=[0.0, 0.5, 0.0],
    order=2,
)

# Adaptive Heun 1(2).  Reference: torchdiffeq/_impl/adaptive_heun.py.
ADAPTIVE_HEUN = _tab(
    alpha=[1.],
    beta_rows=[[1.]],
    c_sol=[0.5, 0.5],
    c_error=[0.5, -0.5],
    c_mid=[0.5, 0.],
    order=2,
)

# Tsitouras 5(4).  Constants from Tsitouras (2011); also in
# OrdinaryDiffEq.jl / diffrax / torchdiffeq/_impl/tsit5.py.
_TSIT5_MID_X = 0.5
TSIT5 = _tab(
    alpha=[
        161 / 1000,
        327 / 1000,
        9 / 10,
        .9800255409045096857298102862870245954942137979563024768854764293221195950761080302604,
        1.,
        1.,
    ],
    beta_rows=[
        [161 / 1000],
        [-.8480655492356988544426874250230774675121177393430391537369234245294192976164141156943e-2,
         .3354806554923569885444268742502307746751211773934303915373692342452941929761641411569],
        [2.897153057105493432130432594192938764924887287701866490314866693455023795137503079289,
         -6.359448489975074843148159912383825625952700647415626703305928850207288721235210244366,
         4.362295432869581411017727318190886861027813359713760212991062156752264926097707165077],
        [5.325864828439256604428877920840511317836476253097040101202360397727981648835607691791,
         -11.74888356406282787774717033978577296188744178259862899288666928009020615663593781589,
         7.495539342889836208304604784564358155658679161518186721010132816213648793440552049753,
         -.9249506636175524925650207933207191611349983406029535244034750452930469056411389539635e-1],
        [5.861455442946420028659251486982647890394337666164814434818157239052507339770711679748,
         -12.92096931784710929170611868178335939541780751955743459166312250439928519268343184452,
         8.159367898576158643180400794539253485181918321135053305748355423955009222648673734986,
         -.7158497328140099722453054252582973869127213147363544882721139659546372402303777878835e-1,
         -.2826905039406838290900305721271224146717633626879770007617876201276764571291579142206e-1],
        [.9646076681806522951816731316512876333711995238157997181903319145764851595234062815396e-1,
         1 / 100,
         .4798896504144995747752495322905965199130404621990332488332634944254542060153074523509,
         1.379008574103741893192274821856872770756462643091360525934940067397245698027561293331,
         -3.290069515436080679901047585711363850115683290894936158531296799594813811049925401677,
         2.324710524099773982415355918398765796109060233222962411944060046314465391054716027841],
    ],
    c_sol=[
        .9468075576583945807478876255758922856117527357724631226139574065785592789071067303271e-1,
        .9183565540343253096776363936645313759813746240984095238905939532922955247253608687270e-2,
        .4877705284247615707855642599631228241516691959761363774365216240304071651579571959813,
        1.234297566930478985655109673884237654035539930748192848315425833500484878378061439761,
        -2.707712349983525454881109975059321670689605166938197378763992255714444407154902012702,
        1.866628418170587035753719399566211498666255505244122593996591602841258328965767580089,
        1 / 66,
    ],
    c_error=[
        -1.780011052225771443378550607539534775944678804333659557637450799792588061629796e-03,
        -8.164344596567469032236360633546862401862537590159047610940604670770447527463931e-04,
        7.880878010261996010314727672526304238628733777103128603258129604952959142646516e-03,
        -1.44711007173262907537165147972635116720922712343167677619514233896760819649515e-01,
        5.823571654525552250199376106520421794260781239567387797673045438803694038950012e-01,
        -4.580821059291869466616365188325542974428047279788398179474684434732070620889539e-01,
        1 / 66,
    ],
    c_mid=[
        -1.0530884977290216 * _TSIT5_MID_X * (_TSIT5_MID_X - 1.329989018975412)
        * (_TSIT5_MID_X**2 - 1.4364028541716351 * _TSIT5_MID_X + 0.7139816917074209),
        0.1017 * _TSIT5_MID_X**2 * (_TSIT5_MID_X**2 - 2.1966568338249754 * _TSIT5_MID_X + 1.2949852507374631),
        2.490627285651252793 * _TSIT5_MID_X**2 * (_TSIT5_MID_X**2 - 2.38535645472061657 * _TSIT5_MID_X + 1.57803468208092486),
        -16.54810288924490272 * (_TSIT5_MID_X - 1.21712927295533244) * (_TSIT5_MID_X - 0.61620406037800089) * _TSIT5_MID_X**2,
        47.37952196281928122 * (_TSIT5_MID_X - 1.203071208372362603) * (_TSIT5_MID_X - 0.658047292653547382) * _TSIT5_MID_X**2,
        -34.87065786149660974 * (_TSIT5_MID_X - 1.2) * (_TSIT5_MID_X - 2 / 3) * _TSIT5_MID_X**2,
        2.5 * (_TSIT5_MID_X - 1) * (_TSIT5_MID_X - 0.6) * _TSIT5_MID_X**2,
    ],
    order=5,
)


# Local-extrapolation Tsit5: propagate the true 5th-order Tsitouras
# solution.  The reference's tsit5 tableau swaps the weight pair: its
# `c_sol` misses the order-5 conditions by ~9e-4 (measured endpoint order
# ~3.9, tests/test_convergence.py) while the true 5th-order weights serve
# only as the error comparator.  `c_sol - c_error` recovers the published
# method (Tsitouras 2011; as in OrdinaryDiffEq.jl / diffrax) and equals
# the final stage row exactly, so the method becomes FSAL with the same
# embedded error estimate.  Same 6 evals/step as the reference's variant
# (which also carries k[-1] as f1, rk_common.py:83-90 — at the *5th-order*
# point while propagating the 4th-order y1; FSAL makes the carried
# derivative consistent with the propagated state and saves the c_sol
# combination).
# Constructed from the final beta row (not the float subtraction) so
# `is_fsal` holds bitwise; the two agree to the last ulp
# (tests/test_convergence.py::test_tsit5_le_tableau).
TSIT5_LE = dataclasses.replace(
    TSIT5, c_sol=np.append(TSIT5.beta[-1], 0.0))


def _dopri8_c_mid():
    h = 1 / 2
    c = [0.0] * 14
    c[0] = (-6.3448349392860401388 * h**5 + 22.1396504998094068976 * h**4
            - 30.0610568289666450593 * h**3 + 19.9990069333683970610 * h**2
            - 6.6910181737837595697 * h + 1.0) * h
    c[5] = (-39.6107919852202505218 * h**5 + 116.4422149550342161651 * h**4
            - 121.4999627731334642623 * h**3 + 52.2273532792945524050 * h**2
            - 7.6142658045872677172 * h) * h
    c[6] = (20.3761213808791436958 * h**5 - 67.1451318825957197185 * h**4
            + 83.1721004639847717481 * h**3 - 46.8919164181093621583 * h**2
            + 10.7281392630428866124 * h) * h
    c[7] = (7.3347098826795362023 * h**5 - 16.5672243527496524646 * h**4
            + 9.5724507555993664382 * h**3 - 0.1890893225010595467 * h**2
            + 0.5526637063753648783 * h) * h
    c[8] = (32.8801774352459155182 * h**5 - 89.9916014847245016028 * h**4
            + 87.8406057677205645007 * h**3 - 35.7075975946222072821 * h**2
            + 4.2186562625665153803 * h) * h
    c[9] = (-10.1588990526426760954 * h**5 + 22.6237489648532849093 * h**4
            - 17.4152107770762969005 * h**3 + 6.2736448083240352160 * h**2
            - 0.6627209125361597559 * h) * h
    c[10] = (-12.5401268098782561200 * h**5 + 32.2362340167355370113 * h**4
             - 28.5903289514790976966 * h**3 + 10.3160881272450748458 * h**2
             - 1.2636789001135462218 * h) * h
    c[11] = (29.5553001484516038033 * h**5 - 82.1020315488359848644 * h**4
             + 81.6630950584341412934 * h**3 - 34.7650769866611817349 * h**2
             + 5.4106037898590422230 * h) * h
    c[12] = (-41.7923486424390588923 * h**5 + 116.2662185791119533462 * h**4
             - 114.9375291377009418170 * h**3 + 47.7457971078225540396 * h**2
             - 7.0321379067945741781 * h) * h
    c[13] = (20.3006925822100825485 * h**5 - 53.9020777466385396792 * h**4
             + 50.2558364226176017553 * h**3 - 19.0082099341608028453 * h**2
             + 2.3537586759714983486 * h) * h
    return c


# Dormand-Prince 7(8), 13-stage.  Reference: torchdiffeq/_impl/dopri8.py.
DOPRI8 = _tab(
    alpha=[1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
           5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1., 1., 1.],
    beta_rows=[
        [1 / 18],
        [1 / 48, 1 / 16],
        [1 / 32, 0, 3 / 32],
        [5 / 16, 0, -75 / 64, 75 / 64],
        [3 / 80, 0, 0, 3 / 16, 3 / 20],
        [29443841 / 614563906, 0, 0, 77736538 / 692538347, -28693883 / 1125000000,
         23124283 / 1800000000],
        [16016141 / 946692911, 0, 0, 61564180 / 158732637, 22789713 / 633445777,
         545815736 / 2771057229, -180193667 / 1043307555],
        [39632708 / 573591083, 0, 0, -433636366 / 683701615, -421739975 / 2616292301,
         100302831 / 723423059, 790204164 / 839813087, 800635310 / 3783071287],
        [246121993 / 1340847787, 0, 0, -37695042795 / 15268766246, -309121744 / 1061227803,
         -12992083 / 490766935, 6005943493 / 2108947869, 393006217 / 1396673457,
         123872331 / 1001029789],
        [-1028468189 / 846180014, 0, 0, 8478235783 / 508512852, 1311729495 / 1432422823,
         -10304129995 / 1701304382, -48777925059 / 3047939560, 15336726248 / 1032824649,
         -45442868181 / 3398467696, 3065993473 / 597172653],
        [185892177 / 718116043, 0, 0, -3185094517 / 667107341, -477755414 / 1098053517,
         -703635378 / 230739211, 5731566787 / 1027545527, 5232866602 / 850066563,
         -4093664535 / 808688257, 3962137247 / 1805957418, 65686358 / 487910083],
        [403863854 / 491063109, 0, 0, -5068492393 / 434740067, -411421997 / 543043805,
         652783627 / 914296604, 11173962825 / 925320556, -13158990841 / 6184727034,
         3936647629 / 1978049680, -160528059 / 685178525, 248638103 / 1413531060, 0],
        [14005451 / 335480064, 0, 0, 0, 0, -59238493 / 1068277825, 181606767 / 758867731,
         561292985 / 797845732, -1041891430 / 1371343529, 760417239 / 1151165299,
         118820643 / 751138087, -528747749 / 2220607170, 1 / 4],
    ],
    c_sol=[14005451 / 335480064, 0, 0, 0, 0, -59238493 / 1068277825,
           181606767 / 758867731, 561292985 / 797845732, -1041891430 / 1371343529,
           760417239 / 1151165299, 118820643 / 751138087, -528747749 / 2220607170,
           1 / 4, 0],
    c_error=[14005451 / 335480064 - 13451932 / 455176623, 0, 0, 0, 0,
             -59238493 / 1068277825 - -808719846 / 976000145,
             181606767 / 758867731 - 1757004468 / 5645159321,
             561292985 / 797845732 - 656045339 / 265891186,
             -1041891430 / 1371343529 - -3867574721 / 1518517206,
             760417239 / 1151165299 - 465885868 / 322736535,
             118820643 / 751138087 - 53011238 / 667516719,
             -528747749 / 2220607170 - 2 / 45, 1 / 4, 0],
    c_mid=_dopri8_c_mid(),
    order=8,
)


# ---------------------------------------------------------------------------
# Implicit fixed-grid tableaus (FIRK / DIRK).
# Reference: torchdiffeq/_impl/fixed_grid_implicit.py.
# ---------------------------------------------------------------------------

_SQRT_2 = np.sqrt(2.0)
_SQRT_3 = np.sqrt(3.0)
_SQRT_6 = np.sqrt(6.0)
_SQRT_15 = np.sqrt(15.0)

IMPLICIT_EULER = _tab(
    alpha=[1.], beta_rows=[[1.]], c_sol=[1.], c_error=[], order=1, implicit=True)

IMPLICIT_MIDPOINT = _tab(
    alpha=[1 / 2], beta_rows=[[1 / 2]], c_sol=[1.], c_error=[], order=2,
    implicit=True)

TRAPEZOID = _tab(
    alpha=[0., 1.],
    beta_rows=[[0., 0.], [1 / 2, 1 / 2]],
    c_sol=[1 / 2, 1 / 2], c_error=[], order=2, implicit=True)

GAUSS_LEGENDRE_4 = _tab(
    # published nodes are 1/2 -+ sqrt(3)/6 (Hairer & Wanner); the reference
    # repeats the first node (fixed_grid_implicit.py:38), which silently
    # degrades its gl4 to first order — verified by convergence-order tests.
    alpha=[1 / 2 - _SQRT_3 / 6, 1 / 2 + _SQRT_3 / 6],
    beta_rows=[
        [1 / 4, 1 / 4 - _SQRT_3 / 6],
        [1 / 4 + _SQRT_3 / 6, 1 / 4],
    ],
    c_sol=[1 / 2, 1 / 2], c_error=[], order=4, implicit=True)

GAUSS_LEGENDRE_6 = _tab(
    alpha=[1 / 2 - _SQRT_15 / 10, 1 / 2, 1 / 2 + _SQRT_15 / 10],
    beta_rows=[
        [5 / 36, 2 / 9 - _SQRT_15 / 15, 5 / 36 - _SQRT_15 / 30],
        [5 / 36 + _SQRT_15 / 24, 2 / 9, 5 / 36 - _SQRT_15 / 24],
        [5 / 36 + _SQRT_15 / 30, 2 / 9 + _SQRT_15 / 15, 5 / 36],
    ],
    c_sol=[5 / 18, 4 / 9, 5 / 18], c_error=[], order=6, implicit=True)

RADAU_IIA_3 = _tab(
    alpha=[1 / 3, 1.],
    beta_rows=[
        [5 / 12, -1 / 12],
        [3 / 4, 1 / 4],
    ],
    c_sol=[3 / 4, 1 / 4], c_error=[], order=3, implicit=True)

RADAU_IIA_5 = _tab(
    alpha=[2 / 5 - _SQRT_6 / 10, 2 / 5 + _SQRT_6 / 10, 1.],
    beta_rows=[
        [11 / 45 - 7 * _SQRT_6 / 360, 37 / 225 - 169 * _SQRT_6 / 1800, -2 / 225 + _SQRT_6 / 75],
        [37 / 225 + 169 * _SQRT_6 / 1800, 11 / 45 + 7 * _SQRT_6 / 360, -2 / 225 - _SQRT_6 / 75],
        [4 / 9 - _SQRT_6 / 36, 4 / 9 + _SQRT_6 / 36, 1 / 9],
    ],
    c_sol=[4 / 9 - _SQRT_6 / 36, 4 / 9 + _SQRT_6 / 36, 1 / 9],
    c_error=[], order=5, implicit=True)

_SDIRK_GAMMA = (2.0 - _SQRT_2) / 2.0
SDIRK2 = _tab(
    alpha=[_SDIRK_GAMMA, 1.],
    beta_rows=[
        [_SDIRK_GAMMA],
        [1 - _SDIRK_GAMMA, _SDIRK_GAMMA],
    ],
    c_sol=[1 - _SDIRK_GAMMA, _SDIRK_GAMMA], c_error=[], order=2,
    implicit=True, sdirk=True)

_TRBDF_GAMMA = 1.0 - _SQRT_2 / 2.0
_TRBDF_BETA = _SQRT_2 / 4.0
TRBDF2 = _tab(
    alpha=[0., 2 * _TRBDF_GAMMA, 1.],
    beta_rows=[
        [0.],
        [_TRBDF_GAMMA, _TRBDF_GAMMA],
        [_TRBDF_BETA, _TRBDF_BETA, _TRBDF_GAMMA],
    ],
    c_sol=[_TRBDF_BETA, _TRBDF_BETA, _TRBDF_GAMMA], c_error=[], order=2,
    implicit=True, sdirk=True)


# ---------------------------------------------------------------------------
# Adaptive implicit (stiff) methods: ESDIRK with embedded error estimates.
#
# Beyond the reference's API (it has fixed-grid implicit only); coefficients
# from Kvaerno (2004), "Singly diagonally implicit Runge-Kutta methods with
# an explicit first stage", BIT Numerical Mathematics 44.  Both tableaus are
# stiffly accurate (y1 = last stage, so f1 = f(t1, y1) carries FSAL-style)
# with an explicit first stage, L-stable in the advancing solution, and an
# embedded lower-order solution for the step-size controller.  Order
# conditions verified to machine precision in tests/test_convergence.py.
#
# The dense-output weights `c_mid` are chosen so the adaptive loop's
# quartic fit reduces to the cubic Hermite through (y0, f0, y1, f1):
#   y_mid = (y0 + y1)/2 + dt (f0 - f1)/8   <=>   c_mid = b/2 + (e0 - es)/8.
# ---------------------------------------------------------------------------


def _hermite_c_mid(b):
    c_mid = np.asarray(b, dtype=np.float64) / 2.0
    c_mid[0] += 0.125
    c_mid[-1] -= 0.125
    return c_mid


def _kvaerno3():
    # gamma: the real root of x^3 - 3x^2 + 3x/2 - 1/6 in (0.3, 0.6)
    r = np.roots([1.0, -3.0, 1.5, -1.0 / 6.0])
    g = float([x.real for x in r
               if abs(x.imag) < 1e-12 and 0.3 < x.real < 0.6][0])
    a2 = [g, g]
    a3 = [(-4 * g ** 2 + 6 * g - 1) / (4 * g), (-2 * g + 1) / (4 * g), g]
    b = [(6 * g - 1) / (12 * g), -1 / ((24 * g - 12) * g),
         (-6 * g ** 2 + 6 * g - 1) / (6 * g - 3), g]
    b_hat = a3 + [0.0]
    return _tab(
        alpha=[0.0, 2 * g, 1.0, 1.0],
        beta_rows=[[0.0], a2, a3, b],
        c_sol=b,
        c_error=list(np.asarray(b) - np.asarray(b_hat)),
        c_mid=_hermite_c_mid(b),
        order=3, implicit=True, sdirk=True)


KVAERNO3 = _kvaerno3()


def _kvaerno5():
    g = 0.26
    a2 = [g, g]
    a3 = [0.13, 0.84033320996790809, g]
    a4 = [0.22371961478320505, 0.47675532319799699, -0.06470895363112615, g]
    a5 = [0.16648564323248321, 0.10450018841591720, 0.03631482272098715,
          -0.13090704451073998, g]
    a6 = [0.13855640231268224, 0.0, -0.04245337201752043,
          0.02446657898003141, 0.61943039072480676, g]
    b = [0.13659751177640291, 0.0, -0.05496908796538376,
         -0.04118626728321046, 0.62993304899016403, 0.06962479448202728, g]
    b_hat = a6 + [0.0]
    return _tab(
        alpha=[0.0, 0.52, 1.230333209967908, 0.8957659843500759,
               0.43639360985864756, 1.0, 1.0],
        beta_rows=[[0.0], a2, a3, a4, a5, a6, b],
        c_sol=b,
        c_error=list(np.asarray(b) - np.asarray(b_hat)),
        c_mid=_hermite_c_mid(b),
        order=5, implicit=True, sdirk=True)


KVAERNO5 = _kvaerno5()


def _radau5a():
    """Adaptive Radau IIA 5(3): the stiff-benchmark standard (Hairer &
    Wanner, "Solving ODEs II", ch. IV.8 / RADAU5) under the adaptive
    loop.  Beyond the reference, whose Radau IIA tier is fixed-grid only
    (torchdiffeq/_impl/fixed_grid_implicit.py:59-108).

    Convention matches the adaptive-implicit tier: stage 0 is the carried
    derivative f(t0, y0) (zero coupling row, zero solution weight); stages
    1..3 are the collocation stages solved as one coupled system
    (implicit=True, sdirk=False -> FIRK step kernel).  The embedded
    3rd-order error weights use an f0 term with Hairer's gamma0 = 1/gamma
    (gamma the real eigenvalue of A^{-1}); order conditions for the
    embedded quadrature hold exactly through q=2 (verified in
    tests/test_convergence.py).  Dense-output mid weights come from the
    collocation polynomial integrated to theta=1/2 (reproduces b at
    theta=1 to machine precision).
    """
    s6 = np.sqrt(6.0)
    c = np.array([2 / 5 - s6 / 10, 2 / 5 + s6 / 10, 1.0])
    A = np.array([
        [11 / 45 - 7 * s6 / 360, 37 / 225 - 169 * s6 / 1800,
         -2 / 225 + s6 / 75],
        [37 / 225 + 169 * s6 / 1800, 11 / 45 + 7 * s6 / 360,
         -2 / 225 - s6 / 75],
        [4 / 9 - s6 / 36, 4 / 9 + s6 / 36, 1 / 9]])
    b = A[-1]

    # embedded order-3 weights (d0 on f0, d on the stages):
    #   d0 + sum d_i = 1, sum d_i c_i = 1/2, sum d_i c_i^2 = 1/3
    gamma = 3.637834252744496   # real eigenvalue of A^{-1} (RADAU5)
    d0 = 1.0 / gamma
    M = np.vstack([np.ones(3), c, c ** 2])
    d = np.linalg.solve(M, np.array([1.0 - d0, 0.5, 1.0 / 3.0]))

    # collocation dense output: b_i(theta) = int_0^theta l_i(tau) dtau
    import numpy.polynomial.polynomial as _P
    c_mid = [0.0]
    for i in range(3):
        others = [c[j] for j in range(3) if j != i]
        num = _P.polyfromroots(others)
        den = np.prod([c[i] - o for o in others])
        c_mid.append(float(_P.polyval(0.5, _P.polyint(num / den))))

    return _tab(
        alpha=[0.0] + list(c),
        beta_rows=[[0.0]] + [[0.0] + list(row) for row in A],
        c_sol=[0.0] + list(b),
        c_error=[d0] + list(d - b),
        c_mid=c_mid,
        order=5, implicit=True, sdirk=False)


RADAU5A = _radau5a()
