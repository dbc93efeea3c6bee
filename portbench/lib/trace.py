"""Reading a ``torch.profiler`` trace of the window.

Host ranges are the ``pb.*`` ``record_function`` ranges of ``spans.py``
(and ``pb.window`` around the whole window); device events are the kernels,
copies and fills on the card's timeline.  A device event belongs to the
innermost ``pb.*`` range open on the launching thread when the launch was
made (the host op or runtime call linked to it by correlation id).

The port's kernel library is called through ctypes and links the CUDA
runtime statically, so the profiler records no host launch for its kernels.
``spans.py`` puts each call into the library inside a ``pb.launch.<entry>``
range.  A stream runs its work in the order it was launched, so such a
kernel was launched by a library call made between the host launches of
the device events just before and just after it on its stream (another
stream's work may start in between, launched at any time); it belongs to
the node range those calls were made in.  Where those calls lie in one
node range, or pair one to one with the kernels, that settles it.  Where
they do neither (a call that launches no kernel, or two), the kernels of
each name pair in order with the calls of the entry that the plain cases
showed launching that name (all the calls, for a name they never showed),
one to one where the counts agree, and else each kernel goes to the latest
of those calls, from the one chosen before it on, that began before it ran.
A kernel with no such call at all goes to the node range open on the main
thread at both ends of the span in which it was launched, or to none.  The
summary counts the kernels placed by each rule and describes the first few
that were not placed plainly.
"""
from __future__ import annotations

import bisect
import collections
import math
from typing import Dict, List, Optional, Tuple


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        ranges, calls, launches, device = [], [], {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                if name.startswith("pb.launch."):
                    calls.append((e.start_ns(), e.start_thread_id(),
                                  name[len("pb.launch."):]))
                elif name.startswith("pb."):
                    ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                   name, e.start_thread_id()))
                    continue
                # a host op or runtime call that launched device work: the
                # innermost (latest-starting) of them marks the launch
                corr = e.linked_correlation_id()
                if corr > 0 and e.start_ns() >= launches.get(corr, (0,))[0]:
                    launches[corr] = (e.start_ns(), e.start_thread_id())
            elif (e.duration_ns() > 0 and not name.startswith("pb.")
                  and not getattr(e, "is_user_annotation", lambda: False)()):
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               name, e.linked_correlation_id(),
                               getattr(e, "device_resource_id", lambda: 0)()))
        self.ranges = sorted(ranges)
        self.device = sorted(device)
        self.calls = sorted(calls)
        win = [r for r in self.ranges if r[2] == "pb.window"]
        if not win:
            raise RuntimeError("the trace holds no pb.window range")
        self.w0, self.w1, _, self.main_tid = win[0]
        # each device event's and each library call's innermost range
        at = [launches.get(d[3]) for d in self.device]
        points = [(a[0], a[1], i) for i, a in enumerate(at) if a is not None]
        points += [(c[0], c[1], -1 - j) for j, c in enumerate(self.calls)]
        self.owner: List[Optional[str]] = [None] * len(self.device)
        self.call_owner: List[Optional[str]] = [None] * len(self.calls)
        self._attribute(points)
        self._own_library_kernels([a[0] if a else None for a in at])

    def _own_library_kernels(self, launched) -> None:
        """Give each device event with no host launch the node range of the
        library calls made between the host launches of its neighbours on
        its stream (see the module's docstring for the rules)."""
        n = len(self.device)
        before, after = [-math.inf] * n, [math.inf] * n
        last: Dict[int, float] = {}
        for i in range(n):
            st = self.device[i][4]
            before[i] = last.get(st, -math.inf)
            if launched[i] is not None:
                last[st] = launched[i]
        last = {}
        for i in reversed(range(n)):
            st = self.device[i][4]
            after[i] = last.get(st, math.inf)
            if launched[i] is not None:
                last[st] = launched[i]
        starts = [c[0] for c in self.calls]
        gaps = collections.defaultdict(list)    # (before, after) -> events
        for i in range(n):
            if launched[i] is None:
                gaps[(before[i], after[i])].append(i)
        spans = []
        learned = collections.defaultdict(collections.Counter)
        for (lo, hi), events in gaps.items():
            k0, k1 = bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)
            spans.append((lo, hi, events, k0, k1))
            names = {self.calls[k][2] for k in range(k0, k1)}
            if k1 - k0 == len(events) or len(names) == 1:
                for j, i in enumerate(events):
                    k = k0 + j if k1 - k0 == len(events) else k0
                    learned[self.device[i][2]][self.calls[k][2]] += 1
        entry_of = {k: c.most_common(1)[0][0] for k, c in learned.items()}
        self.library_kernels = 0
        self.placed: collections.Counter = collections.Counter()
        self.notes: List[str] = []
        self._main = None
        for lo, hi, events, k0, k1 in spans:
            owners = self.call_owner[k0:k1]
            if not owners:
                rule = "by the range open at both ends"
                got = [self._open_both(lo, min(hi, self.device[i][0]))
                       for i in events]
            elif len(set(owners)) == 1:
                rule, got = "in one range", [owners[0]] * len(events)
            elif len(owners) == len(events):
                rule, got = "one to one", owners
            else:
                rule, got = "in order", self._in_order(events, k0, k1,
                                                       entry_of)
            self.placed[rule] += len(events)
            if rule not in ("in one range", "one to one") and len(self.notes) < 3:
                self.notes.append(
                    f"{len(events)} library kernel(s) {rule}: "
                    f"{[self.device[i][2][:40] for i in events][:6]} against "
                    f"calls {[self.calls[k][2] for k in range(k0, k1)][:6]} "
                    f"-> {sorted(set(map(str, got)))}")
            for i, o in zip(events, got):
                self.owner[i] = o
            self.library_kernels += sum(o is not None for o in got)

    def _in_order(self, events, k0, k1, entry_of) -> List[Optional[str]]:
        """The owners of a span's kernels where its calls neither lie in one
        range nor pair one to one with them (see the module's docstring)."""
        by_name = collections.defaultdict(list)
        for i in events:
            by_name[self.device[i][2]].append(i)
        got: Dict[int, Optional[str]] = {}
        for name, evs in by_name.items():
            ks = [k for k in range(k0, k1)
                  if self.calls[k][2] == entry_of.get(name)] or \
                list(range(k0, k1))
            if len(ks) == len(evs):
                pairs = list(zip(evs, ks))
            else:
                pairs, p = [], 0
                for i in evs:
                    began = [j for j in range(p, len(ks))
                             if self.calls[ks[j]][0] <= self.device[i][0]]
                    p = began[-1] if began else p
                    pairs.append((i, ks[p]))
            for i, k in pairs:
                got[i] = self.call_owner[k]
        return [got[i] for i in events]

    def _open_both(self, lo, hi) -> Optional[str]:
        """The innermost node range open on the main thread both at ``lo``
        and at ``hi``, or None."""
        if not math.isfinite(lo):
            return None
        if self._main is None:
            main = [r for r in self.ranges if r[3] == self.main_tid
                    and r[2] != "pb.window"
                    and not r[2].startswith("pb.launch.")]
            self._main = (main, [r[0] for r in main])
        main, starts = self._main
        a = self._open_at(main, starts, lo)
        return a if a == self._open_at(main, starts, hi) and \
            a.startswith("pb.") and a != "pb.window (between calls)" else None

    def summary(self) -> str:
        owned = sum(o is not None for o in self.owner)
        rules = ", ".join(f"{v} {k}" for k, v in sorted(self.placed.items()))
        return "\n".join([
            f"trace: {len(self.ranges)} ranges, {len(self.device)} device "
            f"events, {owned} inside a range ({self.library_kernels} of "
            f"them the library's, by its {len(self.calls)} calls; placed: "
            f"{rules or 'none'}), window {self.window_s():.3f} s",
            *self.notes])

    def _attribute(self, points) -> None:
        """Sweep each thread's ranges (properly nested) and launch points in
        time order, with the open ranges on a stack."""
        by_tid = collections.defaultdict(list)
        for k, r in enumerate(self.ranges):
            by_tid[r[3]].append((r[0], 0, k))      # open
            by_tid[r[3]].append((r[1], 2, k))      # close
        for ts, tid, i in points:
            by_tid[tid].append((ts, 1, i))
        for items in by_tid.values():
            items.sort()
            stack: List[int] = []
            for ts, kind, k in items:
                if kind == 0:
                    stack.append(k)
                elif kind == 2:
                    if k in stack:
                        stack.remove(k)
                elif stack:
                    name = self.ranges[stack[-1]][2]
                    if k >= 0:
                        self.owner[k] = name
                    else:
                        self.call_owner[-1 - k] = name

    # -- readings -----------------------------------------------------------
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device intervals, clipped to the window."""
        out: List[Tuple[int, int]] = []
        for s, e, *_ in self.device:
            s, e = max(s, self.w0), min(e, self.w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s_by(self, prefix: str) -> float:
        """Device seconds of the events whose innermost range starts with
        ``prefix``."""
        return sum((e - s) for (s, e, *_), o in zip(self.device, self.owner)
                   if o is not None and o.startswith(prefix)) / 1e9

    def host_outside(self, outer: str, *inner: str) -> List[float]:
        """Per ``outer`` range, its host seconds outside the ``inner``
        ranges nested in it (same thread; the inner ones do not nest in
        each other)."""
        inners = collections.defaultdict(list)
        for s, e, name, tid in self.ranges:
            if name in inner:
                inners[tid].append((s, e))
        out = []
        for s, e, name, tid in self.ranges:
            if name != outer:
                continue
            covered = sum(min(b, e) - max(a, s) for a, b in inners[tid]
                          if a < e and b > s)
            out.append((e - s - covered) / 1e9)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """Device seconds by node range and kernel, and the longest idle
        gaps by the host range open on the main thread in their middle."""
        ops = collections.Counter()
        for (s, e, name, *_), o in zip(self.device, self.owner):
            ops[f"{o or 'outside'}: {name[:80]}"] += (e - s) / 1e9
        gaps = collections.Counter()
        main = sorted((r for r in self.ranges if r[3] == self.main_tid
                       and r[2] != "pb.window"), key=lambda r: r[0])
        starts = [r[0] for r in main]
        prev = self.w0
        for s, e in self.busy_intervals() + [(self.w1, self.w1)]:
            if s > prev:
                gaps[self._open_at(main, starts, (prev + s) // 2)] += \
                    (s - prev) / 1e9
            prev = max(prev, e)
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}

    @staticmethod
    def _open_at(main, starts, t) -> str:
        """The innermost main-thread range open at ``t``."""
        best: Optional[Tuple] = None
        hi = bisect.bisect_right(starts, t)
        for r in main[max(0, hi - 512):hi]:
            if r[0] <= t < r[1] and (best is None or r[0] >= best[0]):
                best = r
        return best[2] if best else "pb.window (between calls)"
