"""gRPC method wiring: generic handlers + client stubs.

The runtime image has no ``grpc_tools`` codegen, so instead of generated
``*_pb2_grpc.py`` stubs, services are registered with
``grpc.method_handlers_generic_handler`` and clients use
``channel.unary_unary`` with the pb2 (de)serializers — byte-identical wire
behavior to generated stubs. Service/method paths match the reference
(``proto/vdb.proto:90-109``) so its clients interoperate.
"""

from __future__ import annotations

import grpc
from google.protobuf import empty_pb2

from cuda_acceleratedvectordatabaseengine.server.proto import (
    health_pb2,
    vdb_pb2,
)

QUERY_SERVICE = "vdb.QueryService"
ADMIN_SERVICE = "vdb.AdminService"
HEALTH_SERVICE = "grpc.health.v1.Health"


def _unary(method, req_cls, resp_cls):
    return grpc.unary_unary_rpc_method_handler(
        method,
        request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString,
    )


def query_service_handler(servicer) -> grpc.GenericRpcHandler:
    return grpc.method_handlers_generic_handler(QUERY_SERVICE, {
        "Search": _unary(
            servicer.Search, vdb_pb2.SearchRequest, vdb_pb2.SearchResponse
        ),
        "Warmup": _unary(
            servicer.Warmup, vdb_pb2.WarmupRequest, empty_pb2.Empty
        ),
        "LoadIndex": _unary(
            servicer.LoadIndex, vdb_pb2.LoadIndexRequest, empty_pb2.Empty
        ),
        "StreamSearch": grpc.stream_stream_rpc_method_handler(
            servicer.StreamSearch,
            request_deserializer=vdb_pb2.SearchRequest.FromString,
            response_serializer=vdb_pb2.SearchResponse.SerializeToString,
        ),
    })


def admin_service_handler(servicer) -> grpc.GenericRpcHandler:
    return grpc.method_handlers_generic_handler(ADMIN_SERVICE, {
        "CreateIndex": _unary(
            servicer.CreateIndex, vdb_pb2.CreateIndexRequest, empty_pb2.Empty
        ),
        "BuildEpoch": _unary(
            servicer.BuildEpoch, vdb_pb2.BuildEpochRequest, empty_pb2.Empty
        ),
        "ActivateEpoch": _unary(
            servicer.ActivateEpoch, vdb_pb2.ActivateEpochRequest,
            empty_pb2.Empty
        ),
        "GetStats": _unary(
            servicer.GetStats, vdb_pb2.StatsRequest, vdb_pb2.StatsResponse
        ),
        "AddVectors": _unary(
            servicer.AddVectors, vdb_pb2.AddVectorsRequest,
            vdb_pb2.AddVectorsResponse
        ),
        "RemoveVectors": _unary(
            servicer.RemoveVectors, vdb_pb2.RemoveVectorsRequest,
            vdb_pb2.RemoveVectorsResponse
        ),
    })


def health_service_handler(servicer) -> grpc.GenericRpcHandler:
    return grpc.method_handlers_generic_handler(HEALTH_SERVICE, {
        "Check": _unary(
            servicer.Check, health_pb2.HealthCheckRequest,
            health_pb2.HealthCheckResponse
        ),
        "Watch": grpc.unary_stream_rpc_method_handler(
            servicer.Watch,
            request_deserializer=health_pb2.HealthCheckRequest.FromString,
            response_serializer=(
                health_pb2.HealthCheckResponse.SerializeToString
            ),
        ),
    })


class _Stub:
    def __init__(self, channel, service, methods):
        factories = {
            "uu": channel.unary_unary,
            "us": channel.unary_stream,
            "ss": channel.stream_stream,
        }
        for name, (req, resp, kind) in methods.items():
            setattr(self, name, factories[kind](
                f"/{service}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            ))


class QueryServiceClient(_Stub):
    def __init__(self, channel):
        super().__init__(channel, QUERY_SERVICE, {
            "Search": (vdb_pb2.SearchRequest, vdb_pb2.SearchResponse, "uu"),
            "StreamSearch": (vdb_pb2.SearchRequest, vdb_pb2.SearchResponse,
                             "ss"),
            "Warmup": (vdb_pb2.WarmupRequest, empty_pb2.Empty, "uu"),
            "LoadIndex": (vdb_pb2.LoadIndexRequest, empty_pb2.Empty, "uu"),
        })


class AdminServiceClient(_Stub):
    def __init__(self, channel):
        super().__init__(channel, ADMIN_SERVICE, {
            "CreateIndex": (vdb_pb2.CreateIndexRequest, empty_pb2.Empty,
                            "uu"),
            "BuildEpoch": (vdb_pb2.BuildEpochRequest, empty_pb2.Empty, "uu"),
            "ActivateEpoch": (vdb_pb2.ActivateEpochRequest, empty_pb2.Empty,
                              "uu"),
            "GetStats": (vdb_pb2.StatsRequest, vdb_pb2.StatsResponse, "uu"),
            "AddVectors": (vdb_pb2.AddVectorsRequest,
                           vdb_pb2.AddVectorsResponse, "uu"),
            "RemoveVectors": (vdb_pb2.RemoveVectorsRequest,
                              vdb_pb2.RemoveVectorsResponse, "uu"),
        })


class HealthClient(_Stub):
    def __init__(self, channel):
        super().__init__(channel, HEALTH_SERVICE, {
            "Check": (health_pb2.HealthCheckRequest,
                      health_pb2.HealthCheckResponse, "uu"),
            "Watch": (health_pb2.HealthCheckRequest,
                      health_pb2.HealthCheckResponse, "us"),
        })
