"""The work of the served networks, counted from the configuration's
shapes: TFlow's tower and head (ssf_slam_tpu_torch/models/tflow.py).

Each operation is (name, bytes, operations, peak): a Dense layer moves
its input rows, its weight and its output rows once and does 2 rows x in x
out operations on the bf16 tensor cores; the neighbour searches, the IDW
mixes, the scatter softmax-sums and the regroups take the kernel table's
bounds (``bounds.py``); the cost volume's dual-softmax attention its three
K x K x C products a point. Morton sorts, farthest-point sampling,
BatchNorm, activations and max-pools are not counted, so the sum is a
lower bound on what a scan needs. The work is what the step needs, not
which kernels ran: a kernel that is fused, replaced or renamed is held to
the same count.
"""

from __future__ import annotations

from portbench.work import bounds as B

_MIN_WORK = 1 << 20  # ops/neighbors.py::band_params: below it, exact kNN


def band_width(n: int, m: int, k: int) -> int:
    """Candidates a query looks at: the band (ops/neighbors.py::
    band_params) where it tiles, else the whole target cloud."""
    if k > 32 or n * m < _MIN_WORK or n % 256:
        return m
    if m % 256 == 0 and m // 256 >= 3:
        return 256 * 3
    if m % 128 == 0 and m // 128 >= 3:
        return 128 * 3
    return m


class Counter:
    """Accumulates operations of a batch of ``b`` clouds."""

    def __init__(self, b: int, esize: int = B.BF16):
        self.b, self.esize = b, esize
        # (name, kind, bytes, operations, peak)
        self.ops: list[tuple[str, str, float, float, float]] = []

    def add(self, name, nbytes_ops, peak=B.PEAK_F32, kind="neighbour"):
        self.ops.append((name, kind, float(nbytes_ops[0]),
                         float(nbytes_ops[1]), peak))

    def dense(self, name, rows, cin, cout):
        es, b = self.esize, self.b
        self.add(name, (b * (rows * cin * es + cin * cout * es
                             + rows * cout * es), 2 * b * rows * cin * cout),
                 B.PEAK_BF16 if es == B.BF16 else B.PEAK_F32, "dense")

    def mlp(self, name, parts, widths):
        """PointMLP: the first layer one Dense per (rows, width) part, then
        Dense layers over the rows of the widest part."""
        rows = max(r for r, _ in parts)
        for j, (r, c) in enumerate(parts):
            self.dense(f"{name}.part{j}", r, c, widths[0])
        for i in range(1, len(widths)):
            self.dense(f"{name}.{i}", rows, widths[i - 1], widths[i])

    def group(self, name, n, m, k, c):
        """kNN + grouping of [m, c] float32 rows for n queries."""
        self.add(name, B.group_bytes_ops(self.b, n, m, k, c, B.F32,
                                         band_width(n, m, k)))

    def idw(self, name, n, m, k, c):
        self.add(name, B.idw_bytes_ops(self.b, n, m, k, c, self.esize,
                                       band_width(n, m, k)))

    def total(self) -> dict:
        """Summed bytes and operations, the Dense layers' operations, the
        model's (Dense and attention products) and the bound (ms)."""
        ms = sum(B.bound(nb, fl, pk)[0] for _, _, nb, fl, pk in self.ops)
        return dict(bytes=sum(o[2] for o in self.ops),
                    flops=sum(o[3] for o in self.ops),
                    dense_flops=sum(o[3] for o in self.ops
                                    if o[1] == "dense"),
                    model_flops=sum(o[3] for o in self.ops
                                    if o[1] in ("dense", "attention")),
                    bound_ms=ms, n_ops=len(self.ops))


def set_abstraction(c: Counter, name, n, m, k, in_dim, mlp):
    c.group(f"{name}.group", n, m, k, 3 + in_dim)
    c.mlp(f"{name}.mlp", [(n * k, 3), (n * k, in_dim)], mlp)


def set_upconv(c: Counter, name, n_dense, n_sparse, k, sparse_dim,
               dense_dim, mlp, mlp2):
    c.group(f"{name}.group", n_dense, n_sparse, k, 3 + sparse_dim)
    c.mlp(f"{name}.mlp0", [(n_dense * k, sparse_dim), (n_dense * k, 3)], mlp)
    c.mlp(f"{name}.mlp1", [(n_dense, mlp[-1] + dense_dim)], mlp2)


def tower(c: Counter, net: dict):
    """One cloud's half (TFlow.tower)."""
    n0 = net["npoint"]
    pts, ks, mlps = net["sa_npoints"], net["sa_nsample"], net["sa_mlps"]
    c.mlp("point_conv", [(n0, 3)], (32, 32))
    in_dims = (32, mlps[0][-1], mlps[1][-1], mlps[2][-1])
    sizes = (n0, *pts)
    for i in range(4):
        set_abstraction(c, f"sa{i + 1}", sizes[i + 1], sizes[i], ks[i],
                        in_dims[i], mlps[i])
    ups = ((3, mlps[3][-1], mlps[2][-1], (256, 256)),
           (2, 256, mlps[1][-1], (128, 128)),
           (1, 128, mlps[0][-1], (64, 64)),
           (0, 64, 32, (64, 64)))
    for lv, sparse_dim, dense_dim, widths in ups:
        set_upconv(c, f"su{lv}", sizes[lv], sizes[lv + 1],
                   min(16, pts[lv]), sparse_dim, dense_dim, widths, widths)


def cost_volume(c: Counter, name, n, k, d, sf, mlp, flow_mlp, out_ch):
    """AttentiveCostVolume on its unfused branch, n points a cloud."""
    cw = mlp[-1]
    sf_part = [(n, sf)] if sf else []
    for side in ("a", "b"):
        c.group(f"{name}.group_{side}", n, n, k, 3 + d)
        c.mlp(f"{name}.mlp_{side}", [(n, d), (n * k, d)], mlp)
        c.mlp(f"{name}.cost_{side}", [(n * k, cw), *sf_part, (n * k, 3)],
              mlp)
    c.add(f"{name}.attention", B.attention_bytes_ops(c.b * n, k, cw,
                                                     c.esize),
          kind="attention")
    for side in ("q", "k"):
        c.mlp(f"{name}.weightnet_{side}", [(n * k, cw)], (cw, cw // 2, 1))
    c.add(f"{name}.scatter_softmax_sum",
          B.softmax_sum_bytes_ops(c.b, n, k, cw, c.esize, n))
    c.add(f"{name}.regroup", B.regroup_bytes_ops(c.b, n, k, n, cw, c.esize))
    c.mlp(f"{name}.patch", [(n, cw), (n * k, cw), *sf_part, (n * k, 3)], mlp)
    c.mlp(f"{name}.flow", [(n, cw)], flow_mlp)
    c.dense(f"{name}.fc", n, flow_mlp[-1], out_ch)


def head(c: Counter, net: dict):
    """The cross-cloud half (TFlow.head)."""
    n0, pts = net["npoint"], net["sa_npoints"]
    k, uk, wn = net["cost_nsample"], net["upsample_k"], net["warp_nsample"]
    out_ch = 4 if net["joint_seg"] else 3
    sizes = (n0, *pts)
    # (level, d, sf, mlp, flow_mlp) of flow3_r .. flow0_r; deconv widths
    levels = ((3, 256, 0, (256, 256), (128, 128)),
              (2, 192, 128, (128, 128), (128, 128)),
              (1, 96, 128, (64, 64), (64, 64)),
              (0, 96, 64, (64, 64), (64, 64)))
    deconv = {2: (256, 64), 1: (128, 32), 0: (64, 32)}
    lv, d, sf, mlp, fmlp = levels[0]
    cost_volume(c, "flow3_r", sizes[3], k, d, sf, mlp, fmlp, out_ch)
    prev = levels[0]
    for lv, d, sf, mlp, fmlp in levels[1:]:
        n, m = sizes[lv], sizes[lv + 1]
        _, _, _, pmlp, pfmlp = prev
        c.idw(f"up{lv}.multi", n, m, uk[2 - lv],
              out_ch + pfmlp[-1] + pmlp[-1])
        c.idw(f"up{lv}.bwd", n, m, 3, pmlp[-1])
        cin, cout = deconv[lv]
        c.dense(f"deconv{lv}.fwd", n, cin, cout)
        c.dense(f"deconv{lv}.bwd", n, cin, cout)
        c.idw(f"warp{lv}", n, n, wn[3 - lv], out_ch)
        cost_volume(c, f"flow{lv}_r", n, k, d, sf, mlp, fmlp, out_ch)
        prev = (lv, d, sf, mlp, fmlp)


def serve_scan(config: dict) -> dict:
    """One served scan: the current cloud's tower (the previous one is
    cached) and the head. Returns ``Counter.total()`` with the operation
    list."""
    net = config["flownet"]
    c = Counter(1, B.BF16 if net["dtype"] == "bfloat16" else B.F32)
    tower(c, net)
    head(c, net)
    return dict(c.total(), ops=c.ops)

