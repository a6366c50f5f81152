"""Pluggable time-series metrics drivers for the dashboard.

Reference: ``components/centraldashboard/app/metrics_service.ts:1-53``
(driver interface + Interval/TimeSeriesPoint contract),
``prometheus_metrics_service.ts:1-90`` (PromQL range queries),
``metrics_service_factory.ts`` (env-driven driver selection). The
Stackdriver driver of the reference is GCP-console-specific; its slot here
is the charts-link passthrough.

Accelerator addition: a ``gpu_duty`` series, a node's cards' utilization
averaged by node — the fleet-health panel where idle cards show up
immediately. The port of ``kubeflow_tpu/web/dashboard/metrics.py``, whose
``tpu_duty`` series reads the GKE TPU device plugin's duty cycle; here it
reads NVIDIA's dcgm-exporter (``DCGM_FI_DEV_GPU_UTIL``, percent of time a
kernel ran, per card) in Prometheus, and GKE's
``kubernetes.io/container/accelerator/duty_cycle`` in Cloud Monitoring.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Protocol

INTERVALS_MIN = {
    "Last5m": 5,
    "Last15m": 15,
    "Last30m": 30,
    "Last60m": 60,
    "Last180m": 180,
}

# PromQL per series type — node/pod CPU + pod memory mirror the reference's
# queries; gpu_duty is ours. dcgm-exporter runs as a DaemonSet and labels
# each card's series with its node's name as ``Hostname``.
QUERIES = {
    "node_cpu": "sum(rate(node_cpu_seconds_total[5m])) by (instance)",
    "pod_cpu": "sum(rate(container_cpu_usage_seconds_total[5m]))",
    "pod_mem": "sum(container_memory_usage_bytes)",
    "gpu_duty": "avg(DCGM_FI_DEV_GPU_UTIL) by (Hostname)",
}


@dataclass(frozen=True)
class TimeSeriesPoint:
    timestamp: float   # seconds since epoch
    label: str
    value: float

    def to_dict(self) -> dict:
        return {"timestamp": self.timestamp, "label": self.label,
                "value": self.value}


class MetricsService(Protocol):
    async def query(self, series: str, interval: str) -> list[TimeSeriesPoint]:
        """Return the named series over the interval."""
        ...

    def charts_link(self) -> dict:
        """{resourceChartsLink, resourceChartsLinkText} for the UI button."""
        ...

    async def close(self) -> None: ...


class _AiohttpSession:
    """Shared lazy aiohttp session lifecycle for the HTTP drivers."""

    _session = None

    async def _session_get(self):
        import aiohttp

        if self._session is None:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=15)
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


class PrometheusMetricsService(_AiohttpSession):
    """Range queries against a Prometheus-compatible HTTP API.

    ``fetch_json`` is injectable for tests; the default drives aiohttp at
    ``<url>/api/v1/query_range``.
    """

    def __init__(
        self,
        url: str,
        *,
        dashboard_url: str | None = None,
        step_seconds: int = 10,
        queries: dict[str, str] | None = None,
        fetch_json=None,
        clock=time.time,
    ):
        self.url = url.rstrip("/")
        self.dashboard_url = dashboard_url
        self.step_seconds = step_seconds
        self.queries = queries or QUERIES
        self._fetch_json = fetch_json or self._http_fetch
        self._clock = clock
        self._session = None

    async def _http_fetch(self, params: dict) -> dict:
        session = await self._session_get()
        async with session.get(
            f"{self.url}/api/v1/query_range", params=params
        ) as resp:
            resp.raise_for_status()
            return await resp.json()

    async def query(self, series: str, interval: str) -> list[TimeSeriesPoint]:
        if series not in self.queries:
            raise KeyError(f"unknown series {series!r}")
        minutes = INTERVALS_MIN.get(interval)
        if minutes is None:
            raise KeyError(f"unknown interval {interval!r}")
        end = self._clock()
        payload = await self._fetch_json(
            {
                "query": self.queries[series],
                "start": f"{end - minutes * 60:.3f}",
                "end": f"{end:.3f}",
                "step": str(self.step_seconds),
            }
        )
        return self._parse_matrix(payload)

    @staticmethod
    def _parse_matrix(payload: dict) -> list[TimeSeriesPoint]:
        """Prometheus ``matrix`` result → flat point list (the reference's
        convertToTimeSeriesPoints, label = joined metric labels)."""
        data = (payload or {}).get("data") or {}
        if data.get("resultType") != "matrix":
            return []
        points: list[TimeSeriesPoint] = []
        for series in data.get("result", []):
            labels = series.get("metric") or {}
            label = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            for ts, value in series.get("values", []):
                try:
                    points.append(TimeSeriesPoint(float(ts), label, float(value)))
                except (TypeError, ValueError):
                    continue
        return points

    def charts_link(self) -> dict:
        return {
            "resourceChartsLink": self.dashboard_url,
            "resourceChartsLinkText": "View in dashboard",
        }


class CloudMonitoringMetricsService(_AiohttpSession):
    """Google Cloud Monitoring driver (the reference's Stackdriver service,
    ``stackdriver_metrics_service.ts``) — REST against
    ``monitoring.googleapis.com/v3 timeSeries.list``, auth via the GCE
    metadata server's workload-identity token (cached until ~expiry).

    Metric types mirror the reference's ``kubernetes.io`` choices, plus
    GKE's accelerator duty-cycle series (the share of time a container's
    GPUs were busy). ``fetch_json``/``fetch_token`` are injectable for
    tests.
    """

    METRIC_TYPES = {
        "node_cpu": "kubernetes.io/node/cpu/allocatable_utilization",
        "pod_cpu": "kubernetes.io/container/cpu/limit_utilization",
        "pod_mem": "kubernetes.io/container/memory/used_bytes",
        "gpu_duty": "kubernetes.io/container/accelerator/duty_cycle",
    }
    _TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                  "instance/service-accounts/default/token")

    def __init__(self, project: str, *, cluster: str | None = None,
                 fetch_json=None, fetch_token=None, clock=time.time):
        self.project = project
        self.cluster = cluster
        self._fetch_json = fetch_json or self._http_fetch
        self._fetch_token = fetch_token or self._http_token
        self._clock = clock
        self._token: tuple[str, float] | None = None  # (token, expiry)

    async def _http_token(self) -> tuple[str, float]:
        session = await self._session_get()
        async with session.get(
            self._TOKEN_URL, headers={"Metadata-Flavor": "Google"}
        ) as resp:
            resp.raise_for_status()
            body = await resp.json()
        return body["access_token"], self._clock() + body.get("expires_in", 300)

    async def _token_value(self) -> str:
        if self._token is None or self._clock() > self._token[1] - 60:
            self._token = await self._fetch_token()
        return self._token[0]

    async def _http_fetch(self, params: dict) -> dict:
        session = await self._session_get()
        url = (f"https://monitoring.googleapis.com/v3/projects/"
               f"{self.project}/timeSeries")
        headers = {"Authorization": f"Bearer {await self._token_value()}"}
        async with session.get(url, params=params, headers=headers) as resp:
            resp.raise_for_status()
            return await resp.json()

    async def query(self, series: str, interval: str) -> list[TimeSeriesPoint]:
        metric_type = self.METRIC_TYPES.get(series)
        minutes = INTERVALS_MIN.get(interval)
        if metric_type is None or minutes is None:
            raise KeyError(f"unknown series/interval {series!r}/{interval!r}")
        end = self._clock()

        def rfc3339(t: float) -> str:
            return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))

        filt = f'metric.type="{metric_type}"'
        if self.cluster:
            # Without this a multi-cluster project charts every cluster's
            # nodes under colliding labels.
            filt += f' AND resource.label.cluster_name="{self.cluster}"'
        params = {
            "filter": filt,
            "interval.startTime": rfc3339(end - minutes * 60),
            "interval.endTime": rfc3339(end),
            "aggregation.alignmentPeriod": "60s",
            "aggregation.perSeriesAligner": "ALIGN_MEAN",
        }
        points: list[TimeSeriesPoint] = []
        for _page in range(10):  # bounded: 10 pages ≫ any sane dashboard
            payload = await self._fetch_json(params)
            points.extend(self._parse_time_series(payload))
            token = (payload or {}).get("nextPageToken")
            if not token:
                break
            params = {**params, "pageToken": token}
        return points

    @staticmethod
    def _parse_time_series(payload: dict) -> list[TimeSeriesPoint]:
        """timeSeries.list response → flat point list (the reference's
        proto-Timestamp handling, minus the proto)."""
        import calendar

        points: list[TimeSeriesPoint] = []
        for ts in (payload or {}).get("timeSeries", []):
            labels = {**(ts.get("resource") or {}).get("labels", {}),
                      **(ts.get("metric") or {}).get("labels", {})}
            label = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            for p in ts.get("points", []):
                stamp = ((p.get("interval") or {}).get("endTime") or "")
                value = p.get("value") or {}
                raw = value.get("doubleValue", value.get("int64Value"))
                try:
                    when = calendar.timegm(
                        time.strptime(stamp[:19], "%Y-%m-%dT%H:%M:%S")
                    )
                    points.append(TimeSeriesPoint(float(when), label, float(raw)))
                except (TypeError, ValueError):
                    continue
        return points

    def charts_link(self) -> dict:
        return {
            "resourceChartsLink":
                f"https://console.cloud.google.com/monitoring?project={self.project}",
            "resourceChartsLinkText": "View in Cloud Monitoring",
        }


class NullMetricsService:
    """No metrics backend configured — the factory default, like the
    reference dashboard without PROMETHEUS_URL."""

    async def query(self, series: str, interval: str) -> list[TimeSeriesPoint]:
        return []

    def charts_link(self) -> dict:
        return {"resourceChartsLink": None, "resourceChartsLinkText": ""}

    async def close(self) -> None:
        return None


def metrics_service_from_env(env: dict) -> MetricsService:
    """Driver selection (reference metrics_service_factory.ts):
    PROMETHEUS_URL turns the Prometheus driver on;
    CLOUD_MONITORING_PROJECT the Cloud Monitoring (Stackdriver) one.
    Prometheus wins when both are set (it is the in-cluster choice)."""
    url = env.get("PROMETHEUS_URL")
    if url:
        return PrometheusMetricsService(
            url, dashboard_url=env.get("METRICS_DASHBOARD")
        )
    project = env.get("CLOUD_MONITORING_PROJECT")
    if project:
        return CloudMonitoringMetricsService(
            project, cluster=env.get("CLOUD_MONITORING_CLUSTER")
        )
    return NullMetricsService()
