# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: peers.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from gubernator_tpu_torch.api.proto import gubernator_pb2 as gubernator__pb2  # package-relative in the port


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bpeers.proto\x12\rpb.gubernator\x1a\x10gubernator.proto\"g\n\nGlobalSpec\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05limit\x18\x02 \x01(\x03\x12\x10\n\x08\x64uration\x18\x03 \x01(\x03\x12+\n\talgorithm\x18\x04 \x01(\x0e\x32\x18.pb.gubernator.Algorithm\">\n\x12RegisterGlobalsReq\x12(\n\x05specs\x18\x01 \x03(\x0b\x32\x19.pb.gubernator.GlobalSpec\"\x15\n\x13RegisterGlobalsResp\"e\n\x1a\x41pplyGlobalRegistrationReq\x12(\n\x05specs\x18\x01 \x03(\x0b\x32\x19.pb.gubernator.GlobalSpec\x12\x0b\n\x03now\x18\x02 \x01(\x03\x12\x10\n\x08\x61\x63tivate\x18\x03 \x01(\x08\"\x1d\n\x1b\x41pplyGlobalRegistrationResp\"E\n\x14GetPeerRateLimitsReq\x12-\n\x08requests\x18\x01 \x03(\x0b\x32\x1b.pb.gubernator.RateLimitReq\"J\n\x15GetPeerRateLimitsResp\x12\x31\n\x0brate_limits\x18\x01 \x03(\x0b\x32\x1c.pb.gubernator.RateLimitResp\"H\n\x14UpdatePeerGlobalsReq\x12\x30\n\x07globals\x18\x01 \x03(\x0b\x32\x1f.pb.gubernator.UpdatePeerGlobal\"\x8c\x01\n\x10UpdatePeerGlobal\x12\x0b\n\x03key\x18\x01 \x01(\t\x12,\n\x06status\x18\x02 \x01(\x0b\x32\x1c.pb.gubernator.RateLimitResp\x12+\n\talgorithm\x18\x03 \x01(\x0e\x32\x18.pb.gubernator.Algorithm\x12\x10\n\x08\x64uration\x18\x04 \x01(\x03\"\x17\n\x15UpdatePeerGlobalsResp2\x9d\x03\n\x07PeersV1\x12`\n\x11GetPeerRateLimits\x12#.pb.gubernator.GetPeerRateLimitsReq\x1a$.pb.gubernator.GetPeerRateLimitsResp\"\x00\x12`\n\x11UpdatePeerGlobals\x12#.pb.gubernator.UpdatePeerGlobalsReq\x1a$.pb.gubernator.UpdatePeerGlobalsResp\"\x00\x12Z\n\x0fRegisterGlobals\x12!.pb.gubernator.RegisterGlobalsReq\x1a\".pb.gubernator.RegisterGlobalsResp\"\x00\x12r\n\x17\x41pplyGlobalRegistration\x12).pb.gubernator.ApplyGlobalRegistrationReq\x1a*.pb.gubernator.ApplyGlobalRegistrationResp\"\x00\x42\x0cZ\ngubernatorb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'peers_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z\ngubernator'
  _GLOBALSPEC._serialized_start=48
  _GLOBALSPEC._serialized_end=151
  _REGISTERGLOBALSREQ._serialized_start=153
  _REGISTERGLOBALSREQ._serialized_end=215
  _REGISTERGLOBALSRESP._serialized_start=217
  _REGISTERGLOBALSRESP._serialized_end=238
  _APPLYGLOBALREGISTRATIONREQ._serialized_start=240
  _APPLYGLOBALREGISTRATIONREQ._serialized_end=341
  _APPLYGLOBALREGISTRATIONRESP._serialized_start=343
  _APPLYGLOBALREGISTRATIONRESP._serialized_end=372
  _GETPEERRATELIMITSREQ._serialized_start=374
  _GETPEERRATELIMITSREQ._serialized_end=443
  _GETPEERRATELIMITSRESP._serialized_start=445
  _GETPEERRATELIMITSRESP._serialized_end=519
  _UPDATEPEERGLOBALSREQ._serialized_start=521
  _UPDATEPEERGLOBALSREQ._serialized_end=593
  _UPDATEPEERGLOBAL._serialized_start=596
  _UPDATEPEERGLOBAL._serialized_end=736
  _UPDATEPEERGLOBALSRESP._serialized_start=738
  _UPDATEPEERGLOBALSRESP._serialized_end=761
  _PEERSV1._serialized_start=764
  _PEERSV1._serialized_end=1177
# @@protoc_insertion_point(module_scope)
