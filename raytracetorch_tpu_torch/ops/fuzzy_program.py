"""Fuzzy apodization in the fused kernels: a component-style callable
``fn(x, y, z) -> w`` traced once on the host into a short straight-line
program, which K1, K2, K5 and K6 interpret per ray (csrc/fuzzy.cuh).

The TPU kernels of the JAX package run the callable itself inside their
bodies (raytracetorch_tpu/ops/pallas_trace.py: ``_chain_pure`` and
``_nonseq_bounce_core`` multiply a row's factor by it, ``_kernel_v2_bwd``
and ``_kernel_nonseq_bwd_scan`` transpose it with ``jax.vjp``): Mosaic
traces the Python function into the kernel.  A CUDA kernel built once from
the repository's sources cannot, so the callable becomes data that rides
the kernels' arguments as one more side buffer:

- ``trace`` calls the callable once on three tracer values (``_Value``,
  which records every elementwise operation, through Python's operators and
  torch's ``__torch_function__`` protocol) and keeps what the result needs.
  Python numbers of the closure become constants, each rounded once to
  float32, as torch and JAX round a Python scalar against a float32 tensor;
  Python loops over them unroll.  A few operations are lowered into
  ``OPS`` as they are traced, so the kernels need no code for them: ``x **
  k`` for an integer constant k becomes the multiply chain x * x * ... from
  the left (1 / the chain for k < 0, the constant 1 for k = 0); ``a == b``
  becomes ``(a <= b) & (a >= b)`` and ``a != b`` its negation;
  ``torch.minimum(a, b)`` becomes ``where(a <= b, a, b)``,
  ``torch.maximum(a, b)`` ``where(a >= b, a, b)`` and ``torch.clamp(x, lo,
  hi)`` (or ``clip``, either bound optional) the maximum with lo and then
  the minimum with hi (both bounds pass the gradient, as torch.clamp's
  do).  A value tested by Python (``if``, ``bool``, ``float``), an
  operation outside ``OPS`` and those (``sin``, ``cos``, ``log``, a
  non-integer or traced exponent), and a program over ``MAX_OPS``
  operations or ``MAX_REGS`` registers raise NotImplementedError naming
  the callable and what it met.
- Registers are assigned by liveness: a value's register is free again
  after its last use, so the 4-vane telescope pupil (~85 operations) needs
  a handful.  The registers 0, 1 and 2 start with x, y and z.
- ``pack`` lays a table's programs out as one int32 buffer: a word per row
  (its program's offset in the buffer, or -1), then each distinct program
  once (``MAX_WORDS`` in all).  A program is its operation count and result
  register, then two words an operation: ``code | dst << 8 | a << 16 | b <<
  24`` and the third operand (``where``'s second branch) or a constant's
  float32 bits.
- ``evaluate`` is the program's plain version in torch, with the
  forward-mode partials ``dw/d(x, y, z)`` that K2 and K6 carry beside each
  register: a comparison, a mask operation and a mask's cast have none,
  ``where`` selects its branch's, ``abs`` takes sign(a) (0 at 0).  The
  fused traces' plain versions call the callable itself; ``evaluate`` is
  what the kernels compute, for the tests and chip_smoke.py.

Masks are 0 or 1 in the program.  Arithmetic takes a mask as its float
value when the other operand is a float, as torch promotes it; arithmetic on
two masks (which torch keeps boolean) raises.
"""

from __future__ import annotations

import functools
import struct

import torch

# The operations, in the order of their codes (csrc/fuzzy.cuh::FuzzyOp).
OPS = ('const', 'add', 'sub', 'mul', 'div', 'neg', 'abs', 'exp', 'sqrt',
       'lt', 'le', 'gt', 'ge', 'and', 'or', 'not', 'where', 'cast')
CODE = {name: k for k, name in enumerate(OPS)}
# The kernels' limits (csrc/fuzzy.cuh): operations a program, registers (of
# 4 floats in K2 and K6: the value and its three partials), and int32 words
# of a table's packed buffer (8 KB of shared memory).
MAX_OPS = 128
MAX_REGS = 16
MAX_WORDS = 2048
N_INPUTS = 3

_COMPARE = ('lt', 'le', 'gt', 'ge')
_UNARY = ('neg', 'abs', 'exp', 'sqrt')
# torch functions that a callable may call on traced values
_TORCH = {torch.exp: 'exp', torch.sqrt: 'sqrt', torch.abs: 'abs',
          torch.neg: 'neg', torch.negative: 'neg', torch.where: 'where',
          torch.add: 'add', torch.sub: 'sub', torch.mul: 'mul',
          torch.div: 'div', torch.lt: 'lt', torch.le: 'le', torch.gt: 'gt',
          torch.ge: 'ge'}
# torch functions lowered into the op set as they are traced (_Value's
# methods of the same names)
_LOWERED = {torch.pow: 'pow', torch.eq: 'eq', torch.ne: 'ne',
            torch.minimum: 'minimum', torch.maximum: 'maximum',
            torch.clamp: 'clamp', torch.clip: 'clamp'}


def f32(c):
    """A Python number rounded once to float32."""
    return struct.unpack('<f', struct.pack('<f', float(c)))[0]


def f32_bits(c):
    """The float32 bits of ``c`` as a signed int32 word."""
    return struct.unpack('<i', struct.pack('<f', float(c)))[0]


def _callable_name(fn):
    fn = getattr(fn, 'fn', fn)    # a ComponentFuzzy's callable
    return getattr(fn, '__qualname__', None) or repr(fn)


class _Node:
    __slots__ = ('op', 'args', 'const', 'mask')

    def __init__(self, op, args=(), const=None, mask=False):
        self.op, self.args, self.const, self.mask = op, args, const, mask


class _Trace:
    """The nodes a traced callable records: nodes 0, 1 and 2 are x, y and
    z."""

    def __init__(self, name):
        self.name = name
        self.nodes = [_Node('in') for _ in range(N_INPUTS)]

    def refuse(self, what):
        raise NotImplementedError(
            f'fuzzy callable {self.name}: {what}; the fused kernels run '
            f'elementwise {", ".join(OPS[1:])} on component-style '
            f'callables (ops/fuzzy_program.py), simulate() runs any')

    def add(self, op, args=(), const=None, mask=False):
        self.nodes.append(_Node(op, tuple(args), const, mask))
        return _Value(self, len(self.nodes) - 1)

    def operand(self, v):
        """A traced value or a Python (or 0-dim tensor) number -> its
        node."""
        if isinstance(v, _Value):
            if v.trace is not self:
                self.refuse('a value of another trace')
            return v.node
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            v = v.item()
        if isinstance(v, (bool, int, float)):
            return self.add('const', const=f32(v),
                            mask=isinstance(v, bool)).node
        return self.refuse(f'operand {type(v).__name__} (only traced values '
                           f'and numbers)')

    def op(self, op, *vals):
        args = [self.operand(v) for v in vals]
        masks = [self.nodes[a].mask for a in args]
        if op in ('and', 'or', 'not') and not all(masks):
            self.refuse(f'{op} of a float (a mask operation)')
        if op in _UNARY and masks[0]:
            self.refuse(f'{op} of a mask')
        if op in ('add', 'sub', 'mul', 'div') and all(masks):
            self.refuse(f'{op} of two masks')
        if op == 'where':
            if not masks[0]:
                self.refuse('where with a float condition')
            return self.add(op, args, mask=masks[1] and masks[2])
        return self.add(op, args,
                        mask=op in _COMPARE or op in ('and', 'or', 'not'))


class _Value:
    """A traced value: every operation on it records a node."""

    __slots__ = ('trace', 'node')
    __hash__ = object.__hash__

    def __init__(self, trace, node):
        self.trace, self.node = trace, node

    @property
    def dtype(self):
        return torch.bool if self.trace.nodes[self.node].mask \
            else torch.float32

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        trace = next(a.trace for a in args if isinstance(a, _Value))
        if func in _LOWERED:
            if not isinstance(args[0], _Value):
                trace.refuse(f'op {_LOWERED[func]} of a constant first '
                             f'operand')
            return getattr(args[0], _LOWERED[func])(*args[1:],
                                                    **(kwargs or {}))
        op = _TORCH.get(func)
        if op is None or kwargs:
            trace.refuse(f'op {getattr(func, "__name__", func)}'
                         + (f' with {sorted(kwargs)}' if kwargs else ''))
        return trace.op(op, *args)

    def _op(self, op, *others):
        return self.trace.op(op, self, *others)

    def _rop(self, op, other):
        return self.trace.op(op, other, self)

    def __add__(self, o):
        return self._op('add', o)

    def __radd__(self, o):
        return self._rop('add', o)

    def __sub__(self, o):
        return self._op('sub', o)

    def __rsub__(self, o):
        return self._rop('sub', o)

    def __mul__(self, o):
        return self._op('mul', o)

    def __rmul__(self, o):
        return self._rop('mul', o)

    def __truediv__(self, o):
        return self._op('div', o)

    def __rtruediv__(self, o):
        return self._rop('div', o)

    def __neg__(self):
        return self._op('neg')

    def __abs__(self):
        return self._op('abs')

    def __lt__(self, o):
        return self._op('lt', o)

    def __le__(self, o):
        return self._op('le', o)

    def __gt__(self, o):
        return self._op('gt', o)

    def __ge__(self, o):
        return self._op('ge', o)

    def __and__(self, o):
        return self._op('and', o)

    def __rand__(self, o):
        return self._rop('and', o)

    def __or__(self, o):
        return self._op('or', o)

    def __ror__(self, o):
        return self._rop('or', o)

    def __invert__(self):
        return self._op('not')

    def abs(self):
        return self._op('abs')

    def exp(self):
        return self._op('exp')

    def sqrt(self):
        return self._op('sqrt')

    def neg(self):
        return self._op('neg')

    def float(self):
        return self.to(torch.float32)

    def to(self, dtype):
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            self.trace.refuse(f'cast to {dtype}')
        return self._op('cast') if self.trace.nodes[self.node].mask else self

    def __eq__(self, o):
        return (self <= o) & (self >= o)

    def __ne__(self, o):
        return ~(self == o)

    def eq(self, o):
        return self == o

    def ne(self, o):
        return self != o

    def minimum(self, o):
        return self.trace.op('where', self <= o, self, o)

    def maximum(self, o):
        return self.trace.op('where', self >= o, self, o)

    def clamp(self, min=None, max=None):
        out = self if min is None else self.maximum(min)
        return out if max is None else out.minimum(max)

    clip = clamp

    def __bool__(self):
        return self.trace.refuse('a Python if (or bool()) on a traced value '
                                 '(write it with torch.where)')

    def __float__(self):
        return self.trace.refuse('float() of a traced value')

    def __int__(self):
        return self.trace.refuse('int() of a traced value')

    def __index__(self):
        return self.trace.refuse('an index from a traced value')

    def __pow__(self, o):
        if isinstance(o, torch.Tensor) and o.dim() == 0:
            o = o.item()
        if isinstance(o, bool) or not isinstance(o, (int, float)) \
                or o != int(o):
            return self.trace.refuse(f'op pow with exponent {o!r} (an '
                                     f'integer constant unrolls into '
                                     f'multiplies)')
        k = int(o)
        if k == 0:
            return _Value(self.trace, self.trace.operand(1.0))
        out = self
        for _ in range(abs(k) - 1):
            out = out * self
        return out if k > 0 else 1.0 / out

    def __rpow__(self, o):
        return self.trace.refuse('op pow with a traced exponent')

    pow = __pow__

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)
        return self.trace.refuse(f'op {name}')


class Program:
    """A traced callable: ``ops``, tuples ``(code, dst, a, b, c)`` (``c``
    the third operand or a constant's float32 bits), ``out``, the result's
    register, and ``n_regs``, the registers it uses."""

    __slots__ = ('ops', 'out', 'n_regs')

    def __init__(self, ops, out, n_regs):
        self.ops, self.out, self.n_regs = tuple(ops), out, n_regs

    @property
    def words(self):
        """The program as the kernels read it (int32 words)."""
        words = [len(self.ops), self.out]
        for code, dst, a, b, c in self.ops:
            words += [code | dst << 8 | a << 16 | b << 24, c]
        return tuple(words)


def _allocate(trace, out):
    """The nodes ``out`` needs, in order, with registers by liveness ->
    ``Program``."""
    nodes, name = trace.nodes, trace.name
    live, stack = set(), [out]
    while stack:
        n = stack.pop()
        if n not in live:
            live.add(n)
            stack.extend(nodes[n].args)
    order = [n for n in sorted(live) if nodes[n].op != 'in']
    if len(order) > MAX_OPS:
        raise NotImplementedError(
            f'fuzzy callable {name}: {len(order)} operations, over the fused '
            f'kernels\' limit of MAX_OPS = {MAX_OPS}')
    last = {out: len(order)}      # the result stays live to the end
    for j, n in enumerate(order):
        for a in nodes[n].args:
            last[a] = max(last.get(a, j), j)
    reg = {k: k for k in range(N_INPUTS) if k in live}
    free = set(range(MAX_REGS)) - set(reg.values())
    used = max(reg.values(), default=-1) + 1
    ops = []
    for j, n in enumerate(order):
        node = nodes[n]
        regs = [reg[a] for a in node.args]
        for a in set(node.args):
            if last[a] == j:
                free.add(reg[a])
        if not free:
            raise NotImplementedError(
                f'fuzzy callable {name}: needs more than MAX_REGS = '
                f'{MAX_REGS} registers at once in the fused kernels')
        reg[n] = min(free)
        free.discard(reg[n])
        used = max(used, reg[n] + 1)
        regs += [0] * (3 - len(regs))
        if node.op == 'const':
            regs[2] = f32_bits(node.const)
        ops.append((CODE[node.op], reg[n], *regs))
    return Program(ops, reg[out], used)


@functools.lru_cache(maxsize=256)
def trace(fn):
    """The ``Program`` of the component-style callable ``fn`` (traced once
    per callable).  Raises NotImplementedError for a legacy ``[N, 3]``
    callable and for anything outside the op set or the limits."""
    name = _callable_name(fn)
    if not getattr(fn, 'components', False):
        raise NotImplementedError(
            f'fuzzy callable {name}: fuzzy callables on the fused path must '
            f'be component-style (FuzzyAperture(fn, components=True)): the '
            f'kernels hold no [N, 3] hit; simulate() runs it')
    t = _Trace(name)
    w = fn(*(_Value(t, k) for k in range(N_INPUTS)))
    return _allocate(t, t.operand(w))


def pack(fuzzy_fns, n_rows):
    """The int32 words of a table's programs (``fuzzy_fns``, {row:
    callable}): a word per row, its program's offset or -1, then each
    distinct program once.  None without a callable."""
    if not fuzzy_fns:
        return None
    header, body, offsets = [-1] * n_rows, [], {}
    for row in sorted(fuzzy_fns):
        if not 0 <= row < n_rows:
            raise ValueError(f'fuzzy row {row} outside the table\'s '
                             f'0..{n_rows - 1}')
        words = trace(fuzzy_fns[row]).words
        if words not in offsets:
            offsets[words] = n_rows + len(body)
            body.extend(words)
        header[row] = offsets[words]
    if n_rows + len(body) > MAX_WORDS:
        raise NotImplementedError(
            f'the fused kernels\' fuzzy programs take MAX_WORDS = '
            f'{MAX_WORDS} words; this table\'s take {n_rows + len(body)}')
    return tuple(header + body)


def evaluate(program, x, y, z, partials=False):
    """The program's plain version: its value at the ``[N]`` tensors x, y,
    z, as the kernels compute it (each operation rounded on its own), and
    with ``partials`` ``(w, (dw/dx, dw/dy, dw/dz))`` in forward mode."""
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    val = [zero] * MAX_REGS
    grad = [(zero, zero, zero)] * MAX_REGS
    for k, v in enumerate((x, y, z)):
        val[k] = v
        grad[k] = tuple(one if j == k else zero for j in range(N_INPUTS))
    no = (zero, zero, zero)
    for code, dst, a, b, c in program.ops:
        op = OPS[code]
        va, vb = val[a], val[b]
        ga, gb = grad[a], grad[b]
        if op == 'const':
            v = torch.full_like(x, struct.unpack('<f', struct.pack('<i', c))[0])
            g = no
        elif op == 'add':
            v, g = va + vb, tuple(p + q for p, q in zip(ga, gb))
        elif op == 'sub':
            v, g = va - vb, tuple(p - q for p, q in zip(ga, gb))
        elif op == 'mul':
            v, g = va * vb, tuple(p * vb + va * q for p, q in zip(ga, gb))
        elif op == 'div':
            v = va / vb
            g = tuple((p - v * q) / vb for p, q in zip(ga, gb))
        elif op == 'neg':
            v, g = -va, tuple(-p for p in ga)
        elif op == 'abs':
            v = va.abs()
            g = tuple(torch.where(va > 0, p, torch.where(va < 0, -p, zero))
                      for p in ga)
        elif op == 'exp':
            v = va.exp()
            g = tuple(v * p for p in ga)
        elif op == 'sqrt':
            v = va.sqrt()
            g = tuple(p / (v + v) for p in ga)
        elif op in _COMPARE:
            v, g = getattr(torch, op)(va, vb).to(x.dtype), no
        elif op == 'and':
            v, g = ((va != 0) & (vb != 0)).to(x.dtype), no
        elif op == 'or':
            v, g = ((va != 0) | (vb != 0)).to(x.dtype), no
        elif op == 'not':
            v, g = (va == 0).to(x.dtype), no
        elif op == 'where':
            cond = va != 0
            v = torch.where(cond, vb, val[c])
            g = tuple(torch.where(cond, p, q) for p, q in zip(gb, grad[c]))
        else:                                   # cast: a mask's 0 or 1
            v, g = va, no
        val[dst], grad[dst] = v, g
    w = val[program.out]
    return (w, grad[program.out]) if partials else w


def buffer(words, device):
    """A packed program buffer (``pack``) as the int32 tensor the kernels
    read; None for None."""
    if words is None:
        return None
    return torch.tensor(words, dtype=torch.int32, device=device)

